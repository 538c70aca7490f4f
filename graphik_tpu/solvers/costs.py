"""Dense masked EDM-completion costs: f, Euclidean grad, Hessian-vector.

Batched replacement for the reference's numba AOT kernels
(/root/reference/graphik/solvers/costs.py) and the dense numpy closures
(riemannian_solver.py:95-119, 139-174). Everything is expressed as masked
(N, N) x (N, d) linear algebra so XLA fuses the elementwise chains into the
batched matmuls; the edge form (ops/edge.py) and the fused Pallas kernel
(ops/tr_pallas.py) compute the same cost for the hot path.

Conventions (matching the reference):
  D(Y)   = K(Y Y^T),  K(G) = diag(G) 1^T + 1 diag(G)^T - 2 G  (squared EDM)
  f(Y)   = 1/2 ( ||omega o (D_goal - D)||_F^2
               + ||max(psi_L - D, 0) o L_mask||_F^2
               + ||max(D - psi_U, 0) o U_mask||_F^2 )
  egrad  = 2 adj(S) Y,  S = S0 + E1 - E2,  adj(X) = X - Diag(X 1)
  ehess(Z) = 2 ( adj(-M o K(YZ^T + ZY^T)) Y + adj(S) Z ),
             M = omega + L_mask o 1[E1>0] + U_mask o 1[E2>0]

The hinge masks L_mask/U_mask are (psi_L > 0) & (psi_L != psi_U) etc.
(riemannian_solver.py:123-125).
"""

from __future__ import annotations

import jax.numpy as jnp

from graphik_tpu.utils.dgp import distance_matrix_from_gram, distance_matrix_from_pos


def _adj(X):
    """adj(X) = X - Diag(row sums): adjoint of G -> K(G) for symmetric X."""
    row = jnp.sum(X, axis=-1)
    return X - jnp.zeros_like(X).at[..., jnp.arange(X.shape[-1]), jnp.arange(X.shape[-1])].set(row)


def _adj_mv(X, Y):
    """adj(X) @ Y without materializing the diagonal subtraction."""
    row = jnp.sum(X, axis=-1)
    return X @ Y - row[..., :, None] * Y


def residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask):
    D = distance_matrix_from_pos(Y)
    S0 = omega * (D_goal - D)
    E1 = L_mask * jnp.maximum(psi_L - D, 0.0)
    E2 = U_mask * jnp.maximum(D - psi_U, 0.0)
    return D, S0, E1, E2


def _anchor_residuals(Y, anchors):
    """Hinge residuals of selected rows of Y against CONSTANT points.

    `anchors` is the dict from ProblemStructure.reduced_spec() (the
    obstacle reduction): idx (A,), centers (A, d), psi_L/psi_U/L_mask/
    U_mask (A,). Returns (adiff (..., A, d), a1, a2).
    """
    idx = jnp.asarray(anchors["idx"])
    cen = jnp.asarray(anchors["centers"], Y.dtype)
    adiff = Y[..., idx, :] - cen
    adist = jnp.sum(adiff * adiff, axis=-1)
    a1 = jnp.asarray(anchors["L_mask"], Y.dtype) * jnp.maximum(
        jnp.asarray(anchors["psi_L"], Y.dtype) - adist, 0.0)
    a2 = jnp.asarray(anchors["U_mask"], Y.dtype) * jnp.maximum(
        adist - jnp.asarray(anchors["psi_U"], Y.dtype), 0.0)
    return adiff, a1, a2


def _anchor_scatter(Y, idx, vals):
    """Scatter-add (..., A, d) rows back to (..., N, d) at idx."""
    return jnp.zeros_like(Y).at[..., idx, :].add(vals)


def cost(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None):
    _, S0, E1, E2 = residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
    f = 0.5 * (
        jnp.sum(S0 * S0, axis=(-2, -1))
        + jnp.sum(E1 * E1, axis=(-2, -1))
        + jnp.sum(E2 * E2, axis=(-2, -1))
    )
    if anchors is not None:
        _, a1, a2 = _anchor_residuals(Y, anchors)
        f = f + jnp.sum(a1 * a1 + a2 * a2, axis=-1)
    return f


def egrad(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None):
    return cost_and_egrad(
        Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors
    )[1]


def cost_and_egrad(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask,
                   anchors=None):
    _, S0, E1, E2 = residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
    f = 0.5 * (
        jnp.sum(S0 * S0, axis=(-2, -1))
        + jnp.sum(E1 * E1, axis=(-2, -1))
        + jnp.sum(E2 * E2, axis=(-2, -1))
    )
    g = 2.0 * _adj_mv(S0 + E1 - E2, Y)
    if anchors is not None:
        adiff, a1, a2 = _anchor_residuals(Y, anchors)
        f = f + jnp.sum(a1 * a1 + a2 * a2, axis=-1)
        sa = a1 - a2
        idx = jnp.asarray(anchors["idx"])
        g = g - 2.0 * _anchor_scatter(Y, idx, sa[..., None] * adiff)
    return f, g


def ehess(Y, Z, D_goal, omega, psi_L, psi_U, L_mask, U_mask, anchors=None):
    _, S0, E1, E2 = residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
    G_dot = jnp.einsum("...ik,...jk->...ij", Y, Z)
    dD = distance_matrix_from_gram(G_dot + jnp.swapaxes(G_dot, -1, -2))
    M = omega + L_mask * (E1 > 0) + U_mask * (E2 > 0)
    H = 2.0 * (_adj_mv(-M * dD, Y) + _adj_mv(S0 + E1 - E2, Z))
    if anchors is not None:
        adiff, a1, a2 = _anchor_residuals(Y, anchors)
        idx = jnp.asarray(anchors["idx"])
        adiffZ = Z[..., idx, :]
        adD = 2.0 * jnp.sum(adiff * adiffZ, axis=-1)
        sa = a1 - a2
        ma = (jnp.asarray(anchors["L_mask"], Y.dtype) * (a1 > 0)
              + jnp.asarray(anchors["U_mask"], Y.dtype) * (a2 > 0))
        H = H + 2.0 * _anchor_scatter(
            Y, idx, (ma * adD)[..., None] * adiff - sa[..., None] * adiffZ
        )
    return H


def residual_max(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask,
                 anchors=None):
    """Max RELATIVE edge residual: the feasibility-aware stop metric.

    Each equality edge contributes |D_goal - D| / max(D_goal, floor); each
    hinge its violation / max(psi, floor); anchored hinges likewise. The
    per-instance floor is the mean equality-edge squared length, so
    short/zero-length edges measure their absolute residual against the
    robot's characteristic scale instead of blowing up. For an edge of
    length L with endpoint position error delta, the relative residual is
    ~2 delta / L - a max below res_tol implies every edge is satisfied to
    ~res_tol/2 of its length, i.e. the lane is inside the GN polish basin.
    """
    _, S0, E1, E2 = residuals(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
    eq_cnt = jnp.maximum(jnp.sum(omega), 1.0)
    floor = jnp.sum(omega * D_goal, axis=(-2, -1)) / eq_cnt  # (...,)
    fl = floor[..., None, None]
    r = jnp.abs(S0) / jnp.maximum(D_goal, fl)
    r = jnp.maximum(r, E1 / jnp.maximum(psi_L, fl))
    r = jnp.maximum(r, E2 / jnp.maximum(psi_U, fl))
    rmax = jnp.max(r, axis=(-2, -1))
    if anchors is not None:
        _, a1, a2 = _anchor_residuals(Y, anchors)
        pl = jnp.asarray(anchors["psi_L"], Y.dtype)
        pu = jnp.asarray(anchors["psi_U"], Y.dtype)
        flv = floor[..., None]
        ra = jnp.maximum(a1 / jnp.maximum(pl, flv), a2 / jnp.maximum(pu, flv))
        rmax = jnp.maximum(rmax, jnp.max(ra, axis=-1))
    return rmax


def make_masks(omega, psi_L, psi_U):
    """Hinge activity masks (riemannian_solver.py:123-125)."""
    diff = psi_L != psi_U
    L_mask = (diff & (psi_L > 0)).astype(psi_L.dtype)
    U_mask = (diff & (psi_U > 0)).astype(psi_U.dtype)
    return L_mask, U_mask
