"""Edge-list (incidence-matrix) formulation of the EDM-completion cost.

Counterpart of the reference's numba edge kernels
(reference: graphik/solvers/costs.py:7-207): instead of iterating Python
tuples of indices, the active edge set is compiled once into a signed
incidence matrix C in {-1, 0, +1}^{E x N} so that every cost/grad/hvp
evaluation becomes a pair of small matmuls:

    diff  = C Y            (E, d)   edge difference vectors
    dist  = ||diff||^2     (E,)     squared edge lengths
    grad  = -2 C^T (s * diff)       scatter-add as a matmul

Backends sharing this compiled form:
  * pure-JAX functions (work under jit/vmap on any platform) - the
    TRParams(backend="edge") solver path;
  * ops/tr_pallas.py, which fuses the ENTIRE trust-region solve (outer
    loop + tCG) into one Pallas kernel over this same EdgeProblem form -
    TRParams(backend="pallas").

Parity oracles: graphik_tpu.solvers.costs (dense masked path) and
graphik_tpu.native (C++ f64 kernels).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: jit-static arg
class EdgeProblem:
    """Static compiled edge set for one (robot, environment) template.

    Arrays are numpy (host, trace-time constants):
      ei, ej        (E,) int32 upper-triangular edge endpoints
      C             (E, N) signed incidence (+1 at ei, -1 at ej)
      omega, psi_L, psi_U, L_mask, U_mask   (E,) per-edge parameters

    Anchored hinge terms (node vs CONSTANT point - the obstacle reduction,
    graphs/problem.reduced_spec): zero-length arrays when absent.
      aP                       (A, N) one-hot node selection
      acenters                 (A, dim) constant anchor points
      apsi_L, apsi_U, aL_mask, aU_mask  (A,) squared hinge bounds/masks

    Any padding a kernel needs is the kernel's own (ops/tr_pallas.py).
    """

    ei: np.ndarray
    ej: np.ndarray
    C: np.ndarray
    omega: np.ndarray
    psi_L: np.ndarray
    psi_U: np.ndarray
    L_mask: np.ndarray
    U_mask: np.ndarray
    N: int
    dim: int
    aP: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 0)))
    acenters: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3)))
    apsi_L: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    apsi_U: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    aL_mask: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))
    aU_mask: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(0))

    @property
    def E(self) -> int:
        return len(self.ei)

    @property
    def A(self) -> int:
        return self.aP.shape[0]

    def edge_values(self, M) -> jnp.ndarray:
        """Gather per-edge values from a dense (..., N, N) matrix."""
        return jnp.asarray(M)[..., self.ei, self.ej]


def build_edge_problem(omega, psi_L, psi_U, L_mask=None, U_mask=None,
                       dim: int = 3, anchors=None) -> EdgeProblem:
    """Compile dense (N, N) masks into the padded edge/incidence form.

    Keeps every unordered pair where the equality or either hinge term is
    active — the same nonzero-triu set the reference feeds numba
    (riemannian_solver.py:84-93, 130-138).
    """
    omega = np.asarray(omega, np.float64)
    N = omega.shape[-1]
    # Each mask defaults independently so a caller-supplied U_mask is never
    # silently discarded (and L_mask=..., U_mask=None doesn't crash).
    if L_mask is None or U_mask is None:
        diff = np.asarray(psi_L) != np.asarray(psi_U)
        if L_mask is None:
            L_mask = (diff & (np.asarray(psi_L) > 0)).astype(np.float64)
        if U_mask is None:
            U_mask = (diff & (np.asarray(psi_U) > 0)).astype(np.float64)
    active = (omega != 0) | (np.asarray(L_mask) != 0) | (np.asarray(U_mask) != 0)
    iu = np.triu_indices(N, k=1)
    keep = active[iu]
    ei = iu[0][keep].astype(np.int32)
    ej = iu[1][keep].astype(np.int32)
    E = len(ei)

    C = np.zeros((E, N), np.float64)
    C[np.arange(E), ei] = 1.0
    C[np.arange(E), ej] = -1.0

    def sel(M):
        return np.asarray(M, np.float64)[ei, ej]

    akw = {}
    if anchors is not None and len(anchors["idx"]):
        idx = np.asarray(anchors["idx"], np.int64)
        centers = np.asarray(anchors["centers"], np.float64)[:, :dim]
        vals = {k: np.asarray(anchors[k], np.float64)
                for k in ("psi_L", "psi_U", "L_mask", "U_mask")}

        P = np.zeros((len(idx), N), np.float64)
        P[np.arange(len(idx)), idx] = 1.0
        akw = dict(
            aP=P, acenters=centers,
            apsi_L=vals["psi_L"], apsi_U=vals["psi_U"],
            aL_mask=vals["L_mask"], aU_mask=vals["U_mask"],
        )

    return EdgeProblem(
        ei=ei, ej=ej, C=C,
        omega=sel(omega), psi_L=sel(psi_L), psi_U=sel(psi_U),
        L_mask=sel(L_mask), U_mask=sel(U_mask), N=N, dim=dim, **akw,
    )


# ---------------------------------------------------------------------------
# Pure-JAX backend (any platform; composes with jit/vmap/grad)
# ---------------------------------------------------------------------------

def _edge_terms(ep: EdgeProblem, Y, dgoal_e):
    C = jnp.asarray(ep.C, Y.dtype)
    diff = jnp.einsum("en,...nd->...ed", C, Y)
    dist = jnp.sum(diff * diff, axis=-1)
    om = jnp.asarray(ep.omega, Y.dtype)
    s0 = om * (dgoal_e - dist)
    e1 = jnp.asarray(ep.L_mask, Y.dtype) * jnp.maximum(
        jnp.asarray(ep.psi_L, Y.dtype) - dist, 0.0)
    e2 = jnp.asarray(ep.U_mask, Y.dtype) * jnp.maximum(
        dist - jnp.asarray(ep.psi_U, Y.dtype), 0.0)
    return diff, dist, s0, e1, e2


def _anchor_terms(ep: EdgeProblem, Y):
    """Hinge terms against constant anchor points (obstacle reduction)."""
    P = jnp.asarray(ep.aP, Y.dtype)
    diff = jnp.einsum("an,...nd->...ad", P, Y) - jnp.asarray(
        ep.acenters, Y.dtype)
    dist = jnp.sum(diff * diff, axis=-1)
    e1 = jnp.asarray(ep.aL_mask, Y.dtype) * jnp.maximum(
        jnp.asarray(ep.apsi_L, Y.dtype) - dist, 0.0)
    e2 = jnp.asarray(ep.aU_mask, Y.dtype) * jnp.maximum(
        dist - jnp.asarray(ep.apsi_U, Y.dtype), 0.0)
    return diff, e1, e2


def cost(ep: EdgeProblem, Y, dgoal_e):
    """f(Y); dgoal_e = per-edge squared goal distances (see edge_values)."""
    _, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    f = jnp.sum(s0 * s0 + e1 * e1 + e2 * e2, axis=-1)
    if ep.A:
        _, a1, a2 = _anchor_terms(ep, Y)
        f = f + jnp.sum(a1 * a1 + a2 * a2, axis=-1)
    return f


def cost_and_egrad(ep: EdgeProblem, Y, dgoal_e):
    diff, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    f = jnp.sum(s0 * s0 + e1 * e1 + e2 * e2, axis=-1)
    s = s0 + e1 - e2
    C = jnp.asarray(ep.C, Y.dtype)
    g = -2.0 * jnp.einsum("en,...ed->...nd", C, s[..., None] * diff)
    if ep.A:
        adiff, a1, a2 = _anchor_terms(ep, Y)
        f = f + jnp.sum(a1 * a1 + a2 * a2, axis=-1)
        sa = a1 - a2
        P = jnp.asarray(ep.aP, Y.dtype)
        g = g - 2.0 * jnp.einsum("an,...ad->...nd", P, sa[..., None] * adiff)
    return f, g


def egrad(ep: EdgeProblem, Y, dgoal_e):
    return cost_and_egrad(ep, Y, dgoal_e)[1]


def residual_max(ep: EdgeProblem, Y, dgoal_e):
    """Max relative edge residual (see solvers/costs.residual_max)."""
    _, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    om = jnp.asarray(ep.omega, Y.dtype)
    eq_cnt = max(float(np.sum(ep.omega)), 1.0)
    floor = jnp.sum(om * dgoal_e, axis=-1) / eq_cnt  # (...,)
    fl = floor[..., None]
    r = jnp.abs(s0) / jnp.maximum(dgoal_e, fl)
    r = jnp.maximum(r, e1 / jnp.maximum(jnp.asarray(ep.psi_L, Y.dtype), fl))
    r = jnp.maximum(r, e2 / jnp.maximum(jnp.asarray(ep.psi_U, Y.dtype), fl))
    rmax = jnp.max(r, axis=-1)
    if ep.A:
        _, a1, a2 = _anchor_terms(ep, Y)
        ra = jnp.maximum(
            a1 / jnp.maximum(jnp.asarray(ep.apsi_L, Y.dtype), fl),
            a2 / jnp.maximum(jnp.asarray(ep.apsi_U, Y.dtype), fl),
        )
        rmax = jnp.maximum(rmax, jnp.max(ra, axis=-1))
    return rmax


def ehess(ep: EdgeProblem, Y, Z, dgoal_e):
    diff, _, s0, e1, e2 = _edge_terms(ep, Y, dgoal_e)
    C = jnp.asarray(ep.C, Y.dtype)
    diffZ = jnp.einsum("en,...nd->...ed", C, Z)
    dD = 2.0 * jnp.sum(diff * diffZ, axis=-1)
    s = s0 + e1 - e2
    m = (jnp.asarray(ep.omega, Y.dtype)
         + jnp.asarray(ep.L_mask, Y.dtype) * (e1 > 0)
         + jnp.asarray(ep.U_mask, Y.dtype) * (e2 > 0))
    h_e = (m * dD)[..., None] * diff - s[..., None] * diffZ
    H = 2.0 * jnp.einsum("en,...ed->...nd", C, h_e)
    if ep.A:
        adiff, a1, a2 = _anchor_terms(ep, Y)
        P = jnp.asarray(ep.aP, Y.dtype)
        adiffZ = jnp.einsum("an,...nd->...ad", P, Z)
        adD = 2.0 * jnp.sum(adiff * adiffZ, axis=-1)
        sa = a1 - a2
        ma = (jnp.asarray(ep.aL_mask, Y.dtype) * (a1 > 0)
              + jnp.asarray(ep.aU_mask, Y.dtype) * (a2 > 0))
        h_a = (ma * adD)[..., None] * adiff - sa[..., None] * adiffZ
        H = H + 2.0 * jnp.einsum("an,...ad->...nd", P, h_a)
    return H
