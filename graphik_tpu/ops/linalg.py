"""Small-matrix linear algebra as straight-line (unrolled) code.

XLA's generic LU/Cholesky lower to data-dependent loops that are expensive
to compile - and slow to run - when nested inside vmapped while-loops. The
solver hot paths only need tiny SPD solves (the d^2 x d^2 Lyapunov
system, n x n Gauss-Newton steps), so these unrolled versions compile to a
few dozen fused vector ops instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def chol_unrolled(A):
    """Cholesky factor of a small SPD matrix, unrolled over the static size.

    A: (..., m, m) -> lower-triangular L with A = L L^T. The diagonal is
    clamped away from zero so near-singular inputs stay finite (callers add
    their own Tikhonov regularization for semantics).
    """
    m = A.shape[-1]
    L = jnp.zeros_like(A)
    for j in range(m):
        d = A[..., j, j] - jnp.sum(L[..., j, :j] ** 2, axis=-1)
        d = jnp.sqrt(jnp.maximum(d, 1e-30))
        L = L.at[..., j, j].set(d)
        if j + 1 < m:
            off = A[..., j + 1 :, j] - jnp.einsum(
                "...ik,...k->...i", L[..., j + 1 :, :j], L[..., j, :j]
            )
            L = L.at[..., j + 1 :, j].set(off / d[..., None])
    return L


def chol_solve_unrolled(L, b):
    """Solve A x = b given L = chol_unrolled(A). b: (..., m)."""
    m = L.shape[-1]
    y = jnp.zeros_like(b)
    for i in range(m):
        y = y.at[..., i].set(
            (b[..., i] - jnp.sum(L[..., i, :i] * y[..., :i], axis=-1))
            / L[..., i, i]
        )
    x = jnp.zeros_like(b)
    for i in reversed(range(m)):
        x = x.at[..., i].set(
            (y[..., i] - jnp.sum(L[..., i + 1 :, i] * x[..., i + 1 :], axis=-1))
            / L[..., i, i]
        )
    return x


def spd_solve_unrolled(A, b):
    """x = A^{-1} b for small SPD A (..., m, m), b (..., m)."""
    return chol_solve_unrolled(chol_unrolled(A), b)


def chol_blocked(A, block: int = 16):
    """Blocked right-looking Cholesky built from explicit JAX dots.

    `lax.linalg.cholesky` lowers to an internal decomposition whose matmul
    precision is outside `default_matmul_precision`'s reach (float32 may
    run in reduced precision such as TF32), which is catastrophic for the
    ill-conditioned constraint Grams of the CIDGIK ADMM. This version uses
    only jnp ops (unrolled diagonal blocks + HIGHEST-precision trailing
    updates), so f32 results track f64 to ~1e-6.
    """
    import jax

    m = A.shape[-1]
    hp = jax.lax.Precision.HIGHEST
    L = jnp.zeros_like(A)
    for j0 in range(0, m, block):
        j1 = min(j0 + block, m)
        Ablk = A[..., j0:j1, j0:j1] - jnp.matmul(
            L[..., j0:j1, :j0], jnp.swapaxes(L[..., j0:j1, :j0], -1, -2),
            precision=hp,
        )
        Lblk = chol_unrolled(Ablk)
        L = L.at[..., j0:j1, j0:j1].set(Lblk)
        if j1 < m:
            panel = A[..., j1:, j0:j1] - jnp.matmul(
                L[..., j1:, :j0], jnp.swapaxes(L[..., j0:j1, :j0], -1, -2),
                precision=hp,
            )
            # solve panel @ Lblk^T = rhs  (forward substitution, unrolled)
            P = jnp.zeros_like(panel)
            for k in range(j1 - j0):
                acc = panel[..., :, k] - jnp.einsum(
                    "...ij,...j->...i", P[..., :, :k], Lblk[..., k, :k]
                )
                P = P.at[..., :, k].set(acc / Lblk[..., k, k][..., None])
            L = L.at[..., j1:, j0:j1].set(P)
    return L


def tri_lower_inv_blocked(L, block: int = 16):
    """Inverse of a lower-triangular matrix via blocked substitution
    (explicit HIGHEST-precision dots; see chol_blocked)."""
    import jax

    m = L.shape[-1]
    hp = jax.lax.Precision.HIGHEST
    Inv = jnp.zeros_like(L)
    # invert diagonal blocks by unrolled forward substitution on I
    for j0 in range(0, m, block):
        j1 = min(j0 + block, m)
        B = L[..., j0:j1, j0:j1]
        nb = j1 - j0
        E = jnp.zeros_like(B)
        for c in range(nb):
            rhs = jnp.zeros(B.shape[:-2] + (nb,), B.dtype).at[..., c].set(1.0)
            x = jnp.zeros_like(rhs)
            for i in range(nb):
                acc = rhs[..., i] - jnp.einsum(
                    "...j,...j->...", B[..., i, :i], x[..., :i]
                )
                x = x.at[..., i].set(acc / B[..., i, i])
            E = E.at[..., :, c].set(x)
        Inv = Inv.at[..., j0:j1, j0:j1].set(E)
    # off-diagonal blocks: Inv[i, j] = -Dinv_i @ L[i, k] @ Inv[k, j]
    for i0 in range(block, m, block):
        i1 = min(i0 + block, m)
        Dinv = Inv[..., i0:i1, i0:i1]
        for j0 in range(0, i0, block):
            j1 = min(j0 + block, m)
            S = jnp.matmul(
                L[..., i0:i1, j0:i0], Inv[..., j0:i0, j0:j1], precision=hp
            )
            Inv = Inv.at[..., i0:i1, j0:j1].set(
                -jnp.matmul(Dinv, S, precision=hp)
            )
    return Inv


def spd_inverse_factor(A, block: int = 16):
    """Linv with A^{-1} = Linv^T Linv (A SPD), from explicit HIGHEST dots.

    Solving A x = b then costs two HIGHEST-precision matmuls:
    x = Linv^T (Linv b).
    """
    return tri_lower_inv_blocked(chol_blocked(A, block), block)


def mm_unrolled(a, b):
    """(..., n, n) @ (..., n, n) as n broadcast-FMAs instead of a matmul op.

    For tiny n inside long sequential chains (Newton-Schulz on clique
    blocks), each batched-matmul op is a separate kernel whose launch costs
    far more than its trivial flop count; the broadcast formulation is
    pure elementwise work that XLA fuses across the whole chain. Full f32
    accumulation - no reduced-precision matmul involved.
    """
    n = a.shape[-1]
    out = a[..., :, 0, None] * b[..., 0, None, :]
    for k in range(1, n):
        out = out + a[..., :, k, None] * b[..., k, None, :]
    return out


def psd_project_ns(W, iters: int = 14, unroll: bool = False):
    """PSD cone projection P = (W + |W|)/2 via Newton-Schulz matrix sign.

    |W| = W sign(W) for symmetric W, and the sign iterates as
    S_{k+1} = S_k (3 I - S_k^2) / 2 starting from W normalized by its
    Frobenius norm (an upper bound on the spectral radius, guaranteeing
    convergence). Everything is a batched (s, s) matmul -
    versus the ~120 sequential scatter-heavy rotation rounds of a Jacobi
    eigendecomposition. Eigenvalues of magnitude below ~(2/3)^iters of the
    norm have inaccurate signs, but their contribution to P is bounded by
    |lam|/2, so moderate `iters` already gives a projection far inside the
    tolerance of the f32 ADMM that consumes it (solvers/cidgik.py).

    unroll=True switches the matmuls to the fusable broadcast-FMA form
    (mm_unrolled) - the right call for tiny blocks (n <= ~16) where op
    dispatch latency, not flops, dominates.
    """
    hp = jax.lax.Precision.HIGHEST

    if unroll:
        mm = mm_unrolled
    else:
        def mm(a, b):
            return jnp.matmul(a, b, precision=hp)

    W = jnp.asarray(W)
    nrm = jnp.sqrt(jnp.sum(W * W, axis=(-2, -1), keepdims=True))
    safe = jnp.maximum(nrm, jnp.finfo(W.dtype).tiny)
    S = W / safe
    eye = jnp.eye(W.shape[-1], dtype=W.dtype)
    for _ in range(iters):
        S = 0.5 * mm(S, 3.0 * eye - mm(S, S))
    # resymmetrize: rounding drift in the iteration is skew-amplified
    absW = mm(W, S)
    absW = 0.5 * (absW + jnp.swapaxes(absW, -1, -2))
    return 0.5 * (W + absW)
