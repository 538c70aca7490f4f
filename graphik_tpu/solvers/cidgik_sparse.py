"""Sparse (chordal clique-decomposed) CIDGIK.

Batched reimplementation of the reference's sparse SDP machinery
(sdp_snl.py:201-314 per-clique constraint assembly, 661-715 chordal overlap
equality constraints, 448-488 clique cover; convex_iteration.py sparse
mode): the free-node graph is chordally completed (utils/chordal.py, MCS-M)
and each maximal clique S_k gets its own small lifted PSD block

    Z_k = [[ I_d  , X_k^T ],
           [ X_k  , G_k   ]]         X_k in R^{|S_k| x d}

with distance constraints stamped into the clique containing the edge and
overlap equality constraints tying shared rows/diagonals across cliques.
All blocks are padded to the maximum clique size and stacked, so the ADMM
cone projection is ONE batched eigh over (K, ds, ds) - the decomposition
maps onto one batched small-matrix program instead of the
reference's per-clique cvxpy variables.

Where the reference uses a greedy set cover to pick which *augmented*
cliques carry anchor constraints (sdp_snl.py:17-66), anchors here enter
linearly through per-instance positions, so each anchored edge simply
stamps into (one of) its free node's cliques - no cover problem exists.

Bounded (inequality) edges are included in the adjacency used for the
triangulation so every range constraint has a host clique.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import jax
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.solvers.cidgik import (
    FEASIBLE,
    INFEASIBLE,
    CidgikParams,
    _extract_joints,
)
from graphik_tpu.ops.jacobi import jacobi_eigh
from graphik_tpu.ops.linalg import spd_inverse_factor
from graphik_tpu.utils.chordal import chordal_cliques


def _eigh_blocks(Z, sweeps: int):
    """Eigendecomposition of stacked clique blocks (K, ds, ds).

    Always the fixed-sweep Jacobi solver: XLA's BATCHED eigh returns NaN on
    some stacks whose blocks contain exact-zero padded rows (observed on
    CPU, jax 0.9.0 - the same matrices decompose fine one at a time), and
    Jacobi's eps-guarded rotations are immune. sweeps=0 (the "exact"
    float64 oracle setting) maps to 30 sweeps - far past quadratic
    convergence for ds <= 32 (~1e-15 off-diagonal residual).
    """
    return jacobi_eigh(Z, sweeps=sweeps if sweeps else 30)


@dataclasses.dataclass(eq=False)
class CidgikSparseCompiled:
    """Static sparse CIDGIK template.

    Stamp tables describe every constraint as entries into the stacked
    block tensor (K, ds, ds); anchored coefficients are finalized per
    instance from the anchor positions inside jit.
    """

    structure: ProblemStructure
    free_idx: np.ndarray          # (n_free,) problem-node index per free slot
    anchor_idx: np.ndarray        # (n_anchor,)
    cliques: List[List[int]]      # free-slot members per clique
    member: np.ndarray            # (K, smax) free slots, -1 padding
    K: int
    smax: int

    # static constraint stamps: A_static (m_static, K, ds, ds), b (m_static,)
    A_eq_static: np.ndarray
    b_eq_static: np.ndarray
    # anchored equality edges: (m_fa,) tables
    fa_clique: np.ndarray         # clique index
    fa_row: np.ndarray            # local row (0-based within clique)
    fa_anchor: np.ndarray         # anchor slot
    fa_d2: np.ndarray             # squared edge length
    # inequality stamps
    A_in_static: np.ndarray
    in_lo: np.ndarray
    in_hi: np.ndarray
    ina_clique: np.ndarray
    ina_row: np.ndarray
    ina_anchor: np.ndarray
    ina_lo: np.ndarray
    ina_hi: np.ndarray
    # floor_mode planar rows n . x_u = c (free slots; the rows themselves
    # are stamped into A_eq_static - they are batch-static)
    lin_u: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )

    @property
    def d(self) -> int:
        return self.structure.dim

    @property
    def ds(self) -> int:
        return self.d + self.smax

    @property
    def n_free(self) -> int:
        return len(self.free_idx)


def compile_cidgik_sparse(
    ps: ProblemStructure, floor_mode: bool = False
) -> CidgikSparseCompiled:
    """Host-side clique decomposition + constraint stamping.

    floor_mode mirrors the dense compiler (cidgik.compile_cidgik and the
    reference convex_iteration.py:185-192, which passes floor_mode through
    on both the dense and sparse paths): p0/q0 are freed from anchoring
    and constrained to their canonical horizontal planes by linear matrix
    equalities stamped into their host cliques.
    """
    dim = ps.dim
    sdp_nodes = [i for i in range(ps.N) if i not in (ps.idx_x, ps.idx_y)]
    anchor = sorted(i for i in sdp_nodes if ps.anchor_mask[i])
    floor_nodes = []
    if floor_mode:
        if dim != 3:
            raise ValueError("floor_mode requires a 3D problem")
        floor_nodes = [int(ps.idx_p(0)), int(ps.idx_q(0))]
        anchor = [a for a in anchor if a not in floor_nodes]
    free = [i for i in sdp_nodes if i not in set(anchor)]
    free_slot = {node: k for k, node in enumerate(free)}
    anchor_slot = {node: k for k, node in enumerate(anchor)}
    nf = len(free)

    # adjacency over free slots: exact OR bounded edges (bounded edges get a
    # host clique this way; the reference triangulates only DIST edges and
    # patches ranges in afterwards, sdp_snl.py:270-314 + 356-398)
    adj = np.zeros((nf, nf), dtype=bool)
    for a in range(ps.N):
        for b in range(a + 1, ps.N):
            if a in free_slot and b in free_slot and (
                ps.omega_struct[a, b] or ps.bounded_mask[a, b]
            ):
                adj[free_slot[a], free_slot[b]] = True
                adj[free_slot[b], free_slot[a]] = True
    cliques = chordal_cliques(adj)
    K = len(cliques)
    smax = max(len(c) for c in cliques)
    ds = dim + smax
    member = -np.ones((K, smax), dtype=np.int64)
    local = [dict() for _ in range(K)]
    for k, c in enumerate(cliques):
        for j, u in enumerate(c):
            member[k, j] = u
            local[k][u] = j

    def host_clique(u, v=None):
        for k in range(K):
            if u in local[k] and (v is None or v in local[k]):
                return k
        return None

    A_eq, b_eq = [], []
    A_in, lo_l, hi_l = [], [], []
    fa_rows = []
    ina_rows = []

    # identity blocks per clique: Z_k[i, j] = delta_ij, i <= j < d
    for k in range(K):
        for i in range(dim):
            for j in range(i, dim):
                A = np.zeros((K, ds, ds))
                A[k, i, j] += 0.5
                A[k, j, i] += 0.5
                A_eq.append(A)
                b_eq.append(1.0 if i == j else 0.0)

    # floor_mode planar rows: tr(A Z_k) = n . x_u = c, stamped into the
    # node's host clique; batch-static, so they ride A_eq_static through
    # both the vmap and split engines (sdp_snl.py:854-871 semantics).
    lin_u = []
    if floor_nodes:
        pos_fixed = np.asarray(ps.pos_fixed, np.float64)
        n_vec = np.zeros(dim)
        n_vec[-1] = 1.0
        for node in floor_nodes:
            u = free_slot[node]
            k = host_clique(u)
            assert k is not None
            r = dim + local[k][u]
            A = np.zeros((K, ds, ds))
            A[k, r, :dim] += 0.5 * n_vec
            A[k, :dim, r] += 0.5 * n_vec
            A_eq.append(A)
            b_eq.append(float(n_vec @ pos_fixed[node, :dim]))
            lin_u.append(u)

    # overlap equalities (sdp_snl.py:661-715): for every free slot in >1
    # clique, chain consecutive host cliques - X rows (d scalars) and the
    # G diagonal; for shared PAIRS, the G off-diagonal too.
    hosts = [[k for k in range(K) if u in local[k]] for u in range(nf)]
    for u in range(nf):
        hs = hosts[u]
        for k1, k2 in zip(hs[:-1], hs[1:]):
            r1 = dim + local[k1][u]
            r2 = dim + local[k2][u]
            for i in range(dim):  # X^k1_u = X^k2_u
                A = np.zeros((K, ds, ds))
                A[k1, r1, i] += 0.5
                A[k1, i, r1] += 0.5
                A[k2, r2, i] -= 0.5
                A[k2, i, r2] -= 0.5
                A_eq.append(A)
                b_eq.append(0.0)
            A = np.zeros((K, ds, ds))  # G^k1_uu = G^k2_uu
            A[k1, r1, r1] += 1.0
            A[k2, r2, r2] -= 1.0
            A_eq.append(A)
            b_eq.append(0.0)
    for u in range(nf):
        for v in range(u + 1, nf):
            shared = [k for k in range(K) if u in local[k] and v in local[k]]
            for k1, k2 in zip(shared[:-1], shared[1:]):
                A = np.zeros((K, ds, ds))
                ru1, rv1 = dim + local[k1][u], dim + local[k1][v]
                ru2, rv2 = dim + local[k2][u], dim + local[k2][v]
                A[k1, ru1, rv1] += 0.5
                A[k1, rv1, ru1] += 0.5
                A[k2, ru2, rv2] -= 0.5
                A[k2, rv2, ru2] -= 0.5
                A_eq.append(A)
                b_eq.append(0.0)

    def edge_stamp(k, u, v):
        """||x_u - x_v||^2 inside clique k."""
        A = np.zeros((K, ds, ds))
        ru, rv = dim + local[k][u], dim + local[k][v]
        A[k, ru, ru] += 1.0
        A[k, rv, rv] += 1.0
        A[k, ru, rv] -= 1.0
        A[k, rv, ru] -= 1.0
        return A

    for a in range(ps.N):
        for b in range(a + 1, ps.N):
            in_f_a, in_f_b = a in free_slot, b in free_slot
            in_any_a = in_f_a or a in anchor_slot
            in_any_b = in_f_b or b in anchor_slot
            if not (in_any_a and in_any_b):
                continue
            if not in_f_a and not in_f_b:
                continue  # anchor-anchor: constant
            if ps.omega_struct[a, b]:
                d2 = float(ps.D_struct[a, b])
                if in_f_a and in_f_b:
                    u, v = free_slot[a], free_slot[b]
                    k = host_clique(u, v)
                    assert k is not None
                    A_eq.append(edge_stamp(k, u, v))
                    b_eq.append(d2)
                else:
                    f, anc = (a, b) if in_f_a else (b, a)
                    u = free_slot[f]
                    k = host_clique(u)
                    fa_rows.append(
                        (k, local[k][u], anchor_slot[anc], d2)
                    )
            elif ps.bounded_mask[a, b]:
                lo = float(ps.check_L[a, b]) ** 2
                hi = float(ps.check_U[a, b]) ** 2
                if in_f_a and in_f_b:
                    u, v = free_slot[a], free_slot[b]
                    k = host_clique(u, v)
                    assert k is not None
                    A_in.append(edge_stamp(k, u, v))
                    lo_l.append(lo)
                    hi_l.append(hi)
                else:
                    f, anc = (a, b) if in_f_a else (b, a)
                    u = free_slot[f]
                    k = host_clique(u)
                    ina_rows.append(
                        (k, local[k][u], anchor_slot[anc], lo, hi)
                    )

    def stack(lst, shape):
        return (
            np.stack(lst) if lst else np.zeros((0,) + shape)
        )

    fa = np.asarray(fa_rows, dtype=float).reshape(len(fa_rows), 4) \
        if fa_rows else np.zeros((0, 4))
    ina = np.asarray(ina_rows, dtype=float).reshape(len(ina_rows), 5) \
        if ina_rows else np.zeros((0, 5))

    return CidgikSparseCompiled(
        structure=ps,
        free_idx=np.asarray(free, dtype=np.int64),
        anchor_idx=np.asarray(anchor, dtype=np.int64),
        cliques=cliques,
        member=member,
        K=K,
        smax=smax,
        A_eq_static=stack(A_eq, (K, ds, ds)),
        b_eq_static=np.asarray(b_eq, dtype=float),
        fa_clique=fa[:, 0].astype(np.int64),
        fa_row=fa[:, 1].astype(np.int64),
        fa_anchor=fa[:, 2].astype(np.int64),
        fa_d2=fa[:, 3],
        A_in_static=stack(A_in, (K, ds, ds)),
        in_lo=np.asarray(lo_l, dtype=float),
        in_hi=np.asarray(hi_l, dtype=float),
        ina_clique=ina[:, 0].astype(np.int64),
        ina_row=ina[:, 1].astype(np.int64),
        ina_anchor=ina[:, 2].astype(np.int64),
        ina_lo=ina[:, 3],
        ina_hi=ina[:, 4],
        lin_u=np.asarray(lin_u, dtype=np.int64),
    )


def _anchored_stamps(comp: CidgikSparseCompiled, cl, row, anc, anchors_pos,
                     dtype):
    """(m, K, ds, ds) coefficients for anchored edges: G_uu - 2 a^T x_u."""
    m = len(cl)
    K, ds, d = comp.K, comp.ds, comp.d
    A = jnp.zeros((m, K, ds, ds), dtype=dtype)
    if m == 0:
        return A, jnp.zeros((0,), dtype=dtype)
    r = jnp.asarray(row) + d
    k = jnp.asarray(cl)
    a_pos = anchors_pos[jnp.asarray(anc)]  # (m, d)
    mi = jnp.arange(m)
    A = A.at[mi, k, r, r].set(1.0)
    A = A.at[mi[:, None], k[:, None], r[:, None], jnp.arange(d)[None, :]].set(
        -a_pos
    )
    A = A.at[mi[:, None], k[:, None], jnp.arange(d)[None, :], r[:, None]].set(
        -a_pos
    )
    a_norm2 = jnp.sum(a_pos * a_pos, axis=-1)
    return A, a_norm2


def _constraint_tensors(comp: CidgikSparseCompiled, anchors_pos, dtype):
    """Materialize (m_eq, K, ds, ds), b, inequality tensors + boxes."""
    A_eq_s = jnp.asarray(comp.A_eq_static, dtype=dtype)
    b_eq_s = jnp.asarray(comp.b_eq_static, dtype=dtype)
    A_fa, a2 = _anchored_stamps(
        comp, comp.fa_clique, comp.fa_row, comp.fa_anchor, anchors_pos, dtype
    )
    b_fa = jnp.asarray(comp.fa_d2, dtype=dtype) - a2
    A_eq = jnp.concatenate([A_eq_s, A_fa], axis=0)
    b_eq = jnp.concatenate([b_eq_s, b_fa], axis=0)

    A_in_s = jnp.asarray(comp.A_in_static, dtype=dtype)
    A_ina, a2i = _anchored_stamps(
        comp, comp.ina_clique, comp.ina_row, comp.ina_anchor, anchors_pos,
        dtype,
    )
    A_in = jnp.concatenate([A_in_s, A_ina], axis=0)
    lo = jnp.concatenate(
        [jnp.asarray(comp.in_lo, dtype=dtype),
         jnp.asarray(comp.ina_lo, dtype=dtype) - a2i]
    )
    hi = jnp.concatenate(
        [jnp.asarray(comp.in_hi, dtype=dtype),
         jnp.asarray(comp.ina_hi, dtype=dtype) - a2i]
    )

    def rownorm(A):
        return jnp.sqrt(
            jnp.maximum(jnp.sum(A * A, axis=(-3, -2, -1)), 1e-12)
        )

    n_eq = rownorm(A_eq)
    A_eq = A_eq / n_eq[:, None, None, None]
    b_eq = b_eq / n_eq
    if A_in.shape[0]:
        n_in = rownorm(A_in)
        A_in = A_in / n_in[:, None, None, None]
        lo = lo / n_in
        hi = hi / n_in
    return A_eq, b_eq, A_in, lo, hi


def _solve_sdp_admm_blocks(A_eq, b_eq, A_in, lo, hi, C, Z0, t0, U0, params,
                           pad_mask=None):
    """Two-block ADMM over a PRODUCT of PSD cones (stacked clique blocks).

    Identical splitting to the dense solver (cidgik._solve_sdp_admm) with
    Z in (K, ds, ds) and the cone projection a batched eigh over cliques.

    pad_mask: optional (K, ds, ds) 0/1 mask zeroing PADDED rows/cols in the
    cone projection. Padded slots are touched by no constraint and carry no
    cost, so they are free coordinates of the splitting; without the mask
    the over-relaxed iteration parks them at relax-1 (a warm-started dual
    against a vanished cost term), which shows up as a phantom excess-rank
    eigenvalue of exactly relax-1 per padded slot.
    """
    m_eq = A_eq.shape[0]
    m_in = A_in.shape[0]
    rho = params.rho

    A_all = jnp.concatenate([A_eq, A_in], axis=0)  # (m, K, ds, ds)
    Gmm = jnp.einsum("mkij,nkij->mn", A_all, A_all)
    if m_in:
        Gmm = Gmm.at[m_eq:, m_eq:].add(jnp.eye(m_in, dtype=Gmm.dtype))
    Gmm = Gmm + 1e-9 * jnp.trace(Gmm) / Gmm.shape[0] * jnp.eye(
        Gmm.shape[0], dtype=Gmm.dtype
    )
    # Inverse Cholesky factor applied as matmuls: XLA's cho_solve lowers to
    # sequential triangular solves, which dominated the whole sparse ADMM,
    # and its internal matmul precision is outside default_matmul_precision.
    # spd_inverse_factor is the HIGHEST-precision matmul path the dense
    # engine uses (ops/linalg.py).
    Linv = spd_inverse_factor(Gmm)
    hp = jax.lax.Precision.HIGHEST

    def apply_A(A, Z):
        return jnp.einsum("mkij,kij->m", A, Z)

    def apply_inv(v):
        z = jnp.einsum("ij,j->i", Linv, v, precision=hp)
        return jnp.einsum("ji,j->i", Linv, z, precision=hp)

    def solve_gram(r):
        y = apply_inv(r)
        for _ in range(params.refine_steps):
            y = y + apply_inv(r - jnp.einsum(
                "ij,j->i", Gmm, y, precision=hp
            ))
        return y

    def affine_project(Z, t):
        parts = [apply_A(A_eq, Z) - b_eq]
        if m_in:
            parts.append(apply_A(A_in, Z) - t)
        r = jnp.concatenate(parts)
        y = solve_gram(r)
        Z_new = Z - jnp.einsum("m,mkij->kij", y, A_all)
        t_new = t + y[m_eq:] if m_in else t
        return Z_new, t_new

    def cone_project(W, t):
        if pad_mask is not None:
            W = W * pad_mask
        if params.cone_ns_iters:
            # Newton-Schulz matrix-sign projection (ops/linalg): pure
            # batched matmuls; zero padded rows/cols are invariant under
            # the iteration, so the pad structure survives.
            from graphik_tpu.ops.linalg import psd_project_ns

            Wp = psd_project_ns(W, iters=params.cone_ns_iters)
        else:
            lam, Q = _eigh_blocks(W, params.eigh_sweeps)
            lam = jnp.maximum(lam, 0.0)
            Wp = jnp.einsum("kij,kj,klj->kil", Q, lam, Q)
        if pad_mask is not None:
            Wp = Wp * pad_mask
        tp = jnp.clip(t, lo, hi) if m_in else t
        return Wp, tp

    alpha = params.relax

    def cond(carry):
        Z, t, Uz, ut, k, res = carry
        return (res > params.admm_tol) & (k < params.admm_iters)

    def body(carry):
        Z, t, Uz, ut, k, _ = carry
        Z1, t1 = affine_project(Z - Uz - C / rho, t - ut)
        Zr = alpha * Z1 + (1.0 - alpha) * Z
        tr = alpha * t1 + (1.0 - alpha) * t
        Z2, t2 = cone_project(Zr + Uz, tr + ut)
        Uz_new = Uz + Zr - Z2
        ut_new = ut + tr - t2
        res = jnp.sqrt(
            jnp.sum((Z1 - Z2) ** 2)
            + (jnp.sum((t1 - t2) ** 2) if m_in else 0.0)
        )
        return (Z2, t2, Uz_new, ut_new, k + 1, res)

    init = (
        Z0, t0, U0[0], U0[1], jnp.zeros((), jnp.int32),
        jnp.asarray(jnp.inf, Z0.dtype),
    )
    Z, t, Uz, ut, _, _ = jax.lax.while_loop(cond, body, init)

    r_eq = apply_A(A_eq, Z) - b_eq
    feas = jnp.max(jnp.abs(r_eq))
    if m_in:
        v = apply_A(A_in, Z)
        feas = jnp.maximum(
            feas,
            jnp.max(jnp.maximum(lo - v, 0.0) + jnp.maximum(v - hi, 0.0)),
        )
    return Z, t, (Uz, ut), feas


def _fantope_blocks(Z, d, member, eigh_sweeps: int = 8):
    """Per-clique Fantope projection + excess-rank eigenvalue sum.

    Pad-safe formulation: the rank-d-complement projector within each
    block's VALID subspace is C_k = diag(valid_k) - U_d U_d^T with U_d the
    top-d eigenvectors (always inside the valid subspace - the I_d corner
    guarantees d eigenvalues ~1 there), so padded rows never receive cost.
    Excess-rank sum = sum_k (tr Z_k - sum of top-d eigenvalues), the
    per-block generalization of convex_iteration.py:43-53.
    """
    lam, Q = _eigh_blocks(Z, eigh_sweeps)  # (K, ds), ascending
    ds = Z.shape[-1]
    d_top = Q[:, :, ds - d:]  # (K, ds, d) top-d eigenvectors
    proj_top = jnp.einsum("kij,klj->kil", d_top, d_top)
    valid = jnp.asarray(member >= 0)  # (K, smax)
    diag_valid = jnp.concatenate(
        [jnp.ones(valid.shape[:1] + (d,), Z.dtype),
         valid.astype(Z.dtype)], axis=1,
    )  # (K, ds)
    C = jnp.zeros_like(Z) + jnp.einsum(
        "ki,ij->kij", diag_valid, jnp.eye(ds, dtype=Z.dtype)
    ) - proj_top
    eig_sum = jnp.sum(lam) - jnp.sum(lam[:, ds - d:])
    return C, eig_sum


# ---------------------------------------------------------------------------
# Split (static/dynamic) batched sparse ADMM engine
#
# The same decomposition as the dense engine's split operator
# (cidgik.py:_build_split_operator): every constraint row except the ~4-8
# rows touching the GOAL anchors is identical across the batch - identity
# blocks, overlap equalities, free-free edges, and anchored edges whose
# anchor is statically positioned (p0/q0/obstacles). Treating the stacked
# clique blocks as one flattened vector space R^{K ds^2}, the static rows
# become a shared (m_s, K ds^2) matrix: per-iteration work is batched
# shared-weight matmuls instead of the vmapped per-instance
# (m, K, ds, ds) einsums above, and the per-instance (m, m) Gram
# factorization collapses to a host-precomputed float64 Cholesky plus an
# m_d x m_d Schur complement per instance. The vmapped engine remains as
# the oracle path (engine="vmap").
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _SparseSplitOperator:
    """Host-side (numpy, float64) static data for the split sparse ADMM."""

    # static rows, ordered [eq_s | in_s], row-normalized, flattened over
    # the stacked clique blocks
    A_flat: np.ndarray  # (m_s, K*ds*ds)
    b_eq_s: np.ndarray  # (m_eq_s,)
    lo_s: np.ndarray  # (m_in_s,)
    hi_s: np.ndarray  # (m_in_s,)
    G_ss: np.ndarray  # (m_s, m_s) static Gram (+ slack identity on in rows)
    Linv_ss: np.ndarray  # inverse Cholesky factor: G_ss^-1 = Linv^T Linv
    # static-row coefficients at each dynamic row's stamp location
    As_diag: np.ndarray  # (m_s, m_d): A_i[k_j, d+r_j, d+r_j]
    As_rowvec: np.ndarray  # (m_s, m_d, d): A_i[k_j, d+r_j, :d]
    # dynamic rows, ordered [eq_d | in_d] (raw; normalized at runtime)
    k_d: np.ndarray  # (m_d,) host clique
    r_d: np.ndarray  # (m_d,) local row within the clique (0-based)
    g_d: np.ndarray  # (m_d,) goal-anchor slots
    d2_d: np.ndarray  # (m_d,) squared edge length (eq rows; 0 on in rows)
    lo_d: np.ndarray  # (m_d,) raw bounds (in rows; 0 on eq rows)
    hi_d: np.ndarray
    m_eq_d: int
    m_in_d: int
    K_ds: tuple = (0, 0)  # (K, ds) block geometry of the flattened space

    @property
    def m_s(self) -> int:
        return self.A_flat.shape[0]

    @property
    def m_eq_s(self) -> int:
        return len(self.b_eq_s)

    @property
    def m_in_s(self) -> int:
        return len(self.lo_s)

    @property
    def m_d(self) -> int:
        return len(self.k_d)


def _build_sparse_split_operator(
    comp: CidgikSparseCompiled,
) -> _SparseSplitOperator:
    """Assemble the static/dynamic split (cached on the compiled problem)."""
    cached = getattr(comp, "_split_op", None)
    if cached is not None:
        return cached
    ps = comp.structure
    d = comp.d
    K, ds = comp.K, comp.ds
    pos_fixed = np.asarray(ps.pos_fixed, np.float64)

    goal_anchor = set()
    for ee in ps.template.ee:
        goal_anchor.add(ps.idx_p(int(ee)))
        if d == 3:
            goal_anchor.add(ps.idx_q(int(ee)))
        else:
            goal_anchor.add(ps.idx_p(int(ps.template.parents[int(ee)])))
    anchor_is_goal = np.asarray(
        [int(n) in goal_anchor for n in comp.anchor_idx]
    )
    anc_pos = pos_fixed[comp.anchor_idx]  # valid where ~anchor_is_goal

    def fa_stamp(k, r, a):
        """G_uu - 2 a^T x_u inside clique k, local row r."""
        A = np.zeros((K, ds, ds))
        A[k, d + r, d + r] = 1.0
        A[k, d + r, :d] = -a
        A[k, :d, d + r] = -a
        return A

    eq_mats = [comp.A_eq_static[i] for i in range(len(comp.A_eq_static))]
    eq_b = list(comp.b_eq_static)
    dyn = []  # (k, r, g, d2, lo, hi, is_eq)
    for i in range(len(comp.fa_clique)):
        k, r, g = (int(comp.fa_clique[i]), int(comp.fa_row[i]),
                   int(comp.fa_anchor[i]))
        if anchor_is_goal[g]:
            dyn.append((k, r, g, float(comp.fa_d2[i]), 0.0, 0.0, True))
        else:
            a = anc_pos[g, :d]
            eq_mats.append(fa_stamp(k, r, a))
            eq_b.append(float(comp.fa_d2[i]) - a @ a)

    in_mats = [comp.A_in_static[i] for i in range(len(comp.A_in_static))]
    in_lo = list(comp.in_lo)
    in_hi = list(comp.in_hi)
    for i in range(len(comp.ina_clique)):
        k, r, g = (int(comp.ina_clique[i]), int(comp.ina_row[i]),
                   int(comp.ina_anchor[i]))
        if anchor_is_goal[g]:
            dyn.append((k, r, g, 0.0, float(comp.ina_lo[i]),
                        float(comp.ina_hi[i]), False))
        else:
            a = anc_pos[g, :d]
            in_mats.append(fa_stamp(k, r, a))
            in_lo.append(float(comp.ina_lo[i]) - a @ a)
            in_hi.append(float(comp.ina_hi[i]) - a @ a)

    A_s = np.stack(eq_mats + in_mats)  # (m_s, K, ds, ds)
    m_eq_s = len(eq_mats)
    m_in_s = len(in_mats)
    nrm = np.sqrt(np.maximum((A_s**2).sum(axis=(1, 2, 3)), 1e-12))
    A_s = A_s / nrm[:, None, None, None]
    b_eq_s = np.asarray(eq_b) / nrm[:m_eq_s]
    lo_s = np.asarray(in_lo) / nrm[m_eq_s:] if m_in_s else np.zeros(0)
    hi_s = np.asarray(in_hi) / nrm[m_eq_s:] if m_in_s else np.zeros(0)

    A_flat = A_s.reshape(len(A_s), K * ds * ds)
    G_ss = A_flat @ A_flat.T
    if m_in_s:
        G_ss[m_eq_s:, m_eq_s:] += np.eye(m_in_s)
    G_ss += 1e-9 * np.trace(G_ss) / len(G_ss) * np.eye(len(G_ss))
    L = np.linalg.cholesky(G_ss)
    Linv_ss = np.linalg.inv(L)

    dyn_eq = [t for t in dyn if t[6]]
    dyn_in = [t for t in dyn if not t[6]]
    dyn = dyn_eq + dyn_in
    k_d = np.asarray([t[0] for t in dyn], np.int64)
    r_d = np.asarray([t[1] for t in dyn], np.int64)
    As_diag = A_s[:, k_d, d + r_d, d + r_d]  # (m_s, m_d)
    As_rowvec = A_s[:, k_d, d + r_d, :d]  # (m_s, m_d, d)

    op = _SparseSplitOperator(
        A_flat=A_flat,
        b_eq_s=b_eq_s,
        lo_s=lo_s,
        hi_s=hi_s,
        G_ss=G_ss,
        Linv_ss=Linv_ss,
        As_diag=As_diag,
        As_rowvec=As_rowvec,
        k_d=k_d,
        r_d=r_d,
        g_d=np.asarray([t[2] for t in dyn], np.int64),
        d2_d=np.asarray([t[3] for t in dyn], np.float64),
        lo_d=np.asarray([t[4] for t in dyn], np.float64),
        hi_d=np.asarray([t[5] for t in dyn], np.float64),
        m_eq_d=len(dyn_eq),
        m_in_d=len(dyn_in),
        K_ds=(K, ds),
    )
    comp._split_op = op
    return op


def _sparse_split_aux(op: _SparseSplitOperator, anchors_pos, dt):
    """Per-instance dynamic-row data + Schur factor (once per solve).

    Mirrors cidgik._split_aux: the inner products of a dynamic stamp
    D_j(a) (unit diagonal at (k_j, d+r_j) plus the two -a row/column
    copies) with the static rows and with each other are closed-form in a,
    so no (m, K, ds, ds) tensors are ever materialized.
    """
    from graphik_tpu.ops.linalg import chol_unrolled

    hp = jax.lax.Precision.HIGHEST
    B = anchors_pos.shape[0]
    m_d = op.m_d
    d = op.As_rowvec.shape[-1]
    if m_d == 0:
        return {
            "a_d": jnp.zeros((B, 0, d), dt),
            "nrm_d": jnp.zeros((B, 0), dt),
            "b_d": jnp.zeros((B, 0), dt),
            "lo_d": jnp.zeros((B, 0), dt),
            "hi_d": jnp.zeros((B, 0), dt),
            "G_sd": jnp.zeros((B, op.m_s, 0), dt),
            "G_dd": jnp.zeros((B, 0, 0), dt),
            "Ls_schur": jnp.zeros((B, 0, 0), dt),
            "Sinv": jnp.zeros((B, 0, 0), dt),
            "D_flat": jnp.zeros((B, 0, op.A_flat.shape[1]), dt),
        }
    g_d = jnp.asarray(op.g_d)
    a_d = anchors_pos[:, g_d, :]  # (B, m_d, d)
    a2 = jnp.sum(a_d * a_d, axis=-1)
    nrm_d = jnp.sqrt(1.0 + 2.0 * a2)
    is_eq = jnp.arange(m_d) < op.m_eq_d
    b_d = jnp.where(is_eq, (jnp.asarray(op.d2_d, dt) - a2), 0.0) / nrm_d
    lo_d = (jnp.asarray(op.lo_d[op.m_eq_d:], dt) - a2[:, op.m_eq_d:]) / \
        nrm_d[:, op.m_eq_d:]
    hi_d = (jnp.asarray(op.hi_d[op.m_eq_d:], dt) - a2[:, op.m_eq_d:]) / \
        nrm_d[:, op.m_eq_d:]

    Asd_diag = jnp.asarray(op.As_diag, dt)  # (m_s, m_d)
    Asd_vec = jnp.asarray(op.As_rowvec, dt)  # (m_s, m_d, d)
    G_sd = (
        Asd_diag[None] - 2.0 * jnp.einsum(
            "bjk,ijk->bij", a_d, Asd_vec, precision=hp
        )
    ) / nrm_d[:, None, :]

    # <D_j1, D_j2> nonzero only when both stamp the same (clique, row)
    same = jnp.asarray(
        (op.k_d[:, None] == op.k_d[None, :])
        & (op.r_d[:, None] == op.r_d[None, :]), dt
    )
    G_dd = same * (
        1.0 + 2.0 * jnp.einsum("bjd,bkd->bjk", a_d, a_d, precision=hp)
    ) / (nrm_d[:, :, None] * nrm_d[:, None, :])
    if op.m_in_d:
        slack = jnp.concatenate([
            jnp.zeros(op.m_eq_d), jnp.ones(op.m_in_d)
        ]).astype(dt)
        G_dd = G_dd + jnp.diag(slack)[None]

    Linv = jnp.asarray(op.Linv_ss, dt)

    def gss_inv_mat(Rm):  # (B, m_s, m_d)
        z = jnp.einsum("ij,bjm->bim", Linv, Rm, precision=hp)
        return jnp.einsum("ji,bjm->bim", Linv, z, precision=hp)

    W = gss_inv_mat(G_sd)
    S = G_dd - jnp.einsum("bim,bik->bmk", G_sd, W, precision=hp)
    S = S + 1e-7 * jnp.trace(S, axis1=-2, axis2=-1)[..., None, None] / m_d \
        * jnp.eye(m_d, dtype=dt)
    Ls_schur = chol_unrolled(S)
    # Explicit Schur INVERSE (once per solve): the in-loop solve is then a
    # single fusable multiply-reduce instead of 2*m_d sequential
    # substitution steps (pure launch latency).
    from graphik_tpu.ops.linalg import chol_solve_unrolled as _csu

    eye_d = jnp.eye(m_d, dtype=dt)
    Sinv = jax.vmap(
        lambda e: _csu(Ls_schur, jnp.broadcast_to(e, (B, m_d))),
        out_axes=-1,
    )(eye_d)  # (B, m_d, m_d)

    # Dense flattened dynamic-row operator D_flat (B, m_d, K*ds*ds): the
    # stamp matrices materialized ONCE so the hot loop runs multiply-
    # reduces in the flat space instead of advanced-index gather/scatter
    # (which cost launch latency every iteration).
    flat_n = op.A_flat.shape[1]
    K, ds = op.K_ds
    k_d = jnp.asarray(op.k_d)
    r_d = jnp.asarray(op.r_d)
    mi = jnp.arange(m_d)
    D = jnp.zeros((B, m_d, K, ds, ds), dt)
    if m_d:
        D = D.at[:, mi, k_d, d + r_d, d + r_d].set(1.0)
        D = D.at[:, mi, k_d, d + r_d, :d].set(-a_d)
        # separated advanced indices -> index dims move to the front
        D = D.at[:, mi, k_d, :d, d + r_d].set(
            jnp.transpose(-a_d, (1, 0, 2))
        )
    D_flat = (D / nrm_d[:, :, None, None, None]).reshape(B, m_d, flat_n) \
        if m_d else jnp.zeros((B, 0, flat_n), dt)
    return {
        "a_d": a_d, "nrm_d": nrm_d, "b_d": b_d,
        "lo_d": lo_d, "hi_d": hi_d,
        "G_sd": G_sd, "G_dd": G_dd, "Ls_schur": Ls_schur,
        "Sinv": Sinv, "D_flat": D_flat,
    }


def _fantope_blocks_batched(Z, d, member, eigh_sweeps: int = 8):
    """Batched per-clique Fantope projection (see _fantope_blocks).

    Z: (B, K, ds, ds). Returns C (B, K, ds, ds), eig_sum (B,).
    """
    lam, Q = _eigh_blocks(Z, eigh_sweeps)  # (B, K, ds) ascending
    ds = Z.shape[-1]
    d_top = Q[..., ds - d:]  # (B, K, ds, d)
    proj_top = jnp.einsum("...ij,...lj->...il", d_top, d_top)
    valid = jnp.asarray(member >= 0)  # (K, smax)
    diag_valid = jnp.concatenate(
        [jnp.ones(valid.shape[:1] + (d,), Z.dtype),
         valid.astype(Z.dtype)], axis=1,
    )  # (K, ds)
    C = jnp.einsum(
        "ki,ij->kij", diag_valid, jnp.eye(ds, dtype=Z.dtype)
    )[None] - proj_top
    eig_sum = jnp.sum(lam, axis=(-2, -1)) - jnp.sum(
        lam[..., ds - d:], axis=(-2, -1)
    )
    return C, eig_sum


def _solve_sdp_admm_sparse_split(op, aux, C, Z0, t0, U0, params, d, K, ds,
                                 pad_mask):
    """Batched linear-cost SDP solve over the split sparse operator.

    Z0 (B, K, ds, ds), t0 (B, m_in), U0 = (Uz, ut), C (B, K, ds, ds).
    Returns (Z, t, U, feas) batched; feas (B,).
    """
    dt = Z0.dtype
    B = Z0.shape[0]
    m_s = op.m_s
    m_eq_s = op.m_eq_s
    m_in_s = op.m_in_s
    m_d = op.m_d
    m_eq_d = op.m_eq_d
    m_in_d = op.m_in_d
    m_in = m_in_s + m_in_d
    hp = jax.lax.Precision.HIGHEST
    flat = (B, K * ds * ds)

    A_flat = jnp.asarray(op.A_flat, dt)  # (m_s, K*ds*ds)
    b_eq_s = jnp.asarray(op.b_eq_s, dt)
    lo = jnp.concatenate([
        jnp.broadcast_to(jnp.asarray(op.lo_s, dt), (B, m_in_s)),
        aux["lo_d"],
    ], axis=1) if m_in else jnp.zeros((B, 0), dt)
    hi = jnp.concatenate([
        jnp.broadcast_to(jnp.asarray(op.hi_s, dt), (B, m_in_s)),
        aux["hi_d"],
    ], axis=1) if m_in else jnp.zeros((B, 0), dt)
    Linv = jnp.asarray(op.Linv_ss, dt)
    G_ss = jnp.asarray(op.G_ss, dt)
    b_d = aux["b_d"]
    G_sd = aux["G_sd"]
    G_dd = aux["G_dd"]
    Sinv = aux["Sinv"]  # (B, m_d, m_d) explicit Schur inverse
    D_flat = aux["D_flat"]  # (B, m_d, K*ds*ds) dense dynamic rows

    from graphik_tpu.ops.linalg import psd_project_ns

    # The per-iteration ops here are tiny (K*ds^2 ~ a few hundred floats
    # per instance), so the design goal is FUSABILITY, not flops: launch
    # latency of each standalone batched matmul/gather op dominated the
    # first implementation. Dynamic rows therefore run as
    # multiply-reduces against the materialized D_flat, the Schur solve is
    # a multiply-reduce against the precomputed inverse, and the NS cone
    # projection uses the unrolled broadcast-FMA matmuls - all pure
    # elementwise chains XLA fuses.
    def gss_inv(r):  # (B, m_s) -> (B, m_s)
        z = jnp.einsum("ij,bj->bi", Linv, r, precision=hp)
        return jnp.einsum("ji,bj->bi", Linv, z, precision=hp)

    def schur_solve(r):  # (B, m_d)
        return jnp.sum(Sinv * r[:, None, :], axis=-1)

    def apply_A(Zf, t):
        """r = [A(Z) - b; A_in(Z) - t] -> (r_s (B, m_s), r_d (B, m_d))."""
        v_s = jnp.einsum("ms,bs->bm", A_flat, Zf, precision=hp)
        r_s = v_s.at[:, :m_eq_s].add(-b_eq_s)
        if m_in_s:
            r_s = r_s.at[:, m_eq_s:].add(-t[:, :m_in_s])
        if m_d:
            v_d = jnp.sum(D_flat * Zf[:, None, :], axis=-1)
            r_d_vec = v_d - b_d
            if m_in_d:
                r_d_vec = r_d_vec.at[:, m_eq_d:].add(-t[:, m_in_s:])
        else:
            r_d_vec = jnp.zeros((B, 0), dt)
        return r_s, r_d_vec

    def solve_gram(r_s, r_d):
        z_s = gss_inv(r_s)
        if m_d:
            rhs_d = r_d - jnp.einsum("bim,bi->bm", G_sd, z_s, precision=hp)
            y_d = schur_solve(rhs_d)
            y_s = gss_inv(
                r_s - jnp.einsum("bim,bm->bi", G_sd, y_d, precision=hp)
            )
        else:
            y_d = r_d
            y_s = z_s
        for _ in range(params.refine_steps):
            Gy_s = jnp.einsum("ij,bj->bi", G_ss, y_s, precision=hp)
            if m_d:
                Gy_s = Gy_s + jnp.einsum(
                    "bim,bm->bi", G_sd, y_d, precision=hp
                )
                Gy_d = jnp.einsum(
                    "bim,bi->bm", G_sd, y_s, precision=hp
                ) + jnp.einsum("bjk,bk->bj", G_dd, y_d, precision=hp)
            else:
                Gy_d = y_d
            e_s = r_s - Gy_s
            e_d = r_d - Gy_d if m_d else r_d
            z_s = gss_inv(e_s)
            if m_d:
                rhs_d = e_d - jnp.einsum(
                    "bim,bi->bm", G_sd, z_s, precision=hp
                )
                dy_d = schur_solve(rhs_d)
                dy_s = gss_inv(
                    e_s - jnp.einsum("bim,bm->bi", G_sd, dy_d, precision=hp)
                )
            else:
                dy_d = e_d
                dy_s = z_s
            y_s = y_s + dy_s
            y_d = y_d + dy_d if m_d else y_d
        return y_s, y_d

    def adjoint(y_s, y_d):
        """dZ in the FLAT space (B, K*ds*ds) + slack part."""
        Zc = jnp.einsum("ms,bm->bs", A_flat, y_s, precision=hp)
        if m_d:
            Zc = Zc + jnp.sum(y_d[:, :, None] * D_flat, axis=1)
        parts = []
        if m_in_s:
            parts.append(y_s[:, m_eq_s:])
        if m_in_d:
            parts.append(y_d[:, m_eq_d:])
        dt_vec = (jnp.concatenate(parts, axis=1) if parts
                  else jnp.zeros((B, 0), dt))
        return Zc, dt_vec

    def affine_project(Zf, t):
        r_s, r_d_vec = apply_A(Zf, t)
        y_s, y_d = solve_gram(r_s, r_d_vec)
        dZ, dt_vec = adjoint(y_s, y_d)
        return Zf - dZ, t + dt_vec

    def cone_project(Wf, t):
        W = Wf.reshape(B, K, ds, ds) * pad_mask
        if params.cone_ns_iters:
            Wp = psd_project_ns(W, iters=params.cone_ns_iters, unroll=True)
        else:
            lam, Q = _eigh_blocks(W, params.eigh_sweeps)
            lam = jnp.maximum(lam, 0.0)
            Wp = jnp.einsum("...ij,...j,...lj->...il", Q, lam, Q)
        Wp = Wp * pad_mask
        tp = jnp.clip(t, lo, hi) if m_in else t
        return Wp.reshape(flat), tp

    alpha = params.relax
    rho = params.rho
    Cf = C.reshape(flat)

    def cond(carry):
        Z, t, Uz, ut, k, res = carry
        return (jnp.max(res) > params.admm_tol) & (k < params.admm_iters)

    def body(carry):
        Zf, t, Uz, ut, k, _ = carry
        Z1, t1 = affine_project(Zf - Uz - Cf / rho, t - ut)
        Zr = alpha * Z1 + (1.0 - alpha) * Zf
        tr = alpha * t1 + (1.0 - alpha) * t
        Z2, t2 = cone_project(Zr + Uz, tr + ut)
        Uz_new = Uz + Zr - Z2
        ut_new = ut + tr - t2
        pri = jnp.sqrt(
            jnp.sum((Z1 - Z2) ** 2, axis=-1)
            + (jnp.sum((t1 - t2) ** 2, axis=-1) if m_in else 0.0)
        )
        return (Z2, t2, Uz_new, ut_new, k + 1, pri)

    init = (Z0.reshape(flat), t0, U0[0].reshape(flat), U0[1],
            jnp.zeros((), jnp.int32), jnp.full((B,), jnp.inf, dt))
    Zf, t, Uzf, ut, _, _ = jax.lax.while_loop(cond, body, init)
    Z = Zf.reshape(B, K, ds, ds)
    Uz = Uzf.reshape(B, K, ds, ds)

    v_s, v_d = apply_A(Zf, jnp.zeros_like(t))
    feas = jnp.max(jnp.abs(v_s[:, :m_eq_s]), axis=-1)
    if m_in_s:
        vv = v_s[:, m_eq_s:]
        vio = jnp.maximum(lo[:, :m_in_s] - vv, 0.0) + jnp.maximum(
            vv - hi[:, :m_in_s], 0.0
        )
        feas = jnp.maximum(feas, jnp.max(vio, axis=-1))
    if m_eq_d:
        feas = jnp.maximum(feas, jnp.max(jnp.abs(v_d[:, :m_eq_d]), axis=-1))
    if m_in_d:
        vv = v_d[:, m_eq_d:]
        vio_d = jnp.maximum(aux["lo_d"] - vv, 0.0) + jnp.maximum(
            vv - aux["hi_d"], 0.0
        )
        feas = jnp.maximum(feas, jnp.max(vio_d, axis=-1))
    return Z, t, (Uz, ut), feas


def _solve_cidgik_sparse_split(comp, T_goal, pos_all, anchors_pos, params):
    """Convex-iteration driver over the split batched sparse ADMM."""
    ps = comp.structure
    d = comp.d
    K, ds = comp.K, comp.ds
    dt = pos_all.dtype
    batch = pos_all.shape[:-2]
    B = int(np.prod(batch)) if batch else 1
    anc = anchors_pos.reshape(B, len(comp.anchor_idx), d)
    op = _build_sparse_split_operator(comp)
    aux = _sparse_split_aux(op, anc, dt)
    m_in = op.m_in_s + op.m_in_d

    valid_np = np.concatenate(
        [np.ones((K, d), bool), comp.member >= 0], axis=1
    )  # (K, ds)
    pad_mask = jnp.asarray(
        (valid_np[:, :, None] & valid_np[:, None, :]).astype(np.float64),
        dt,
    )
    diag_valid = jnp.asarray(
        np.einsum("ki,ij->kij", valid_np.astype(np.float64), np.eye(ds)), dt
    )

    Z0 = jnp.zeros((B, K, ds, ds), dt)
    Z0 = Z0.at[:, :, :d, :d].set(jnp.eye(d, dtype=dt))
    t0 = jnp.zeros((B, m_in), dt)
    if m_in:
        lo = jnp.concatenate([
            jnp.broadcast_to(jnp.asarray(op.lo_s, dt), (B, op.m_in_s)),
            aux["lo_d"],
        ], axis=1)
        hi = jnp.concatenate([
            jnp.broadcast_to(jnp.asarray(op.hi_s, dt), (B, op.m_in_s)),
            aux["hi_d"],
        ], axis=1)
        t0 = jnp.clip(t0, lo, hi)
    U0 = (jnp.zeros((B, K, ds, ds), dt), jnp.zeros((B, m_in), dt))
    C0 = jnp.broadcast_to(diag_valid, (B, K, ds, ds))

    def keep(done, old, new):
        mask = done.reshape(done.shape + (1,) * (old.ndim - 1))
        return jnp.where(mask, old, new)

    def make_outer(round_params):
        def outer(carry, _):
            Z, t, U, C, last_cost, done, feas_prev, eig_prev = carry
            Z_new, t_new, U_new, feas = _solve_sdp_admm_sparse_split(
                op, aux, C, Z, t, U, round_params, d, K, ds, pad_mask
            )
            C_new, eig_sum = _fantope_blocks_batched(
                Z_new, d, comp.member, params.eigh_sweeps
            )
            cost = jnp.sum(C * Z_new, axis=(-3, -2, -1))
            change = jnp.abs(last_cost - cost)
            rel = change / jnp.maximum(jnp.abs(last_cost), 1e-30)
            new_done = done | (
                (change <= params.abs_tol)
                | (cost <= params.abs_tol)
                | (rel < params.rel_tol)
            )
            return (
                keep(done, Z, Z_new),
                keep(done, t, t_new),
                jax.tree.map(lambda o, n: keep(done, o, n), U, U_new),
                keep(done, C, C_new),
                keep(done, last_cost, cost),
                new_done,
                keep(done, feas_prev, feas),
                keep(done, eig_prev, eig_sum),
            ), None
        return outer

    init = (
        Z0, t0, U0, C0,
        jnp.full((B,), 1e6, dt),
        jnp.zeros((B,), bool),
        jnp.full((B,), jnp.inf, dt),
        jnp.full((B,), jnp.inf, dt),
    )
    with jax.default_matmul_precision("highest"):
        # (long, short) schedule: round 0 cold-solves; warm-started rounds
        # reuse the primal/dual point and need far fewer iterations.
        carry, _ = jax.lax.scan(make_outer(params), init, None, length=1)
        if params.max_outer > 1:
            rest = params
            if params.admm_iters_rest is not None:
                rest = dataclasses.replace(
                    params, admm_iters=params.admm_iters_rest
                )
            carry, _ = jax.lax.scan(
                make_outer(rest), carry, None,
                length=params.max_outer - 1,
            )
        (Z, t, U, C, cost, done, feas, eig_sum) = carry

        # assemble free positions: average shared rows across cliques
        X = jnp.zeros((B, comp.n_free, d), dtype=dt)
        count = np.zeros((comp.n_free,))
        for k in range(K):
            for j, u in enumerate(comp.cliques[k]):
                X = X.at[:, u].add(Z[:, k, d + j, :d])
                count[u] += 1.0
        X = X / jnp.asarray(count, dt)[None, :, None]
        points = pos_all.reshape(B, ps.N, d)
        points = points.at[:, jnp.asarray(comp.free_idx), :].set(X)
        status = jnp.where(feas <= params.feas_tol, FEASIBLE, INFEASIBLE)

        points = points.reshape(batch + (ps.N, d))
        status = status.reshape(batch)
        eig_sum = eig_sum.reshape(batch)
        feas = feas.reshape(batch)
        q, T_base = _extract_joints(ps, comp, points, T_goal)
    return {
        "q": q,
        "T_base": T_base,
        "points": points,
        "status": status,
        "eig_sum": eig_sum,
        "feas": feas,
    }


def solve_cidgik_sparse(
    comp: CidgikSparseCompiled,
    T_goal,
    params: CidgikParams = CidgikParams(),
    dtype=None,
    engine: str = "split",
):
    """Batched sparse CIDGIK solve (convex_iteration.py sparse mode).

    Returns dict: q, points (all problem nodes), status, eig_sum, feas,
    T_base. For anchored problems T_base is the identity; under floor_mode
    it is the solved rigid base pose on the floor plane (the gauge freed by
    the planar constraints) and q is extracted in that base frame via
    realign_floor_solution, so the world end-effector pose of q is
    T_base @ fk(q).

    engine: "split" (default) runs the static/dynamic split batched ADMM
    (shared-weight matmuls over the flattened clique blocks, host
    float64 static Gram factor, per-instance m_d x m_d Schur complement);
    "vmap" is the original per-instance engine (oracle path).
    """
    ps = comp.structure
    pos_all = ps.goal_positions(T_goal, dtype=dtype)
    dt = pos_all.dtype
    d = comp.d
    K, ds = comp.K, comp.ds
    member = jnp.asarray(comp.member)

    anchors_pos = pos_all[..., jnp.asarray(comp.anchor_idx), :]

    if engine == "split":
        return _solve_cidgik_sparse_split(
            comp, T_goal, pos_all, anchors_pos, params
        )

    # valid-subspace mask: d identity rows + the clique's member rows
    valid_np = np.concatenate(
        [np.ones((K, d), bool), comp.member >= 0], axis=1
    )  # (K, ds)
    pad_mask = (
        valid_np[:, :, None] & valid_np[:, None, :]
    ).astype(np.float64)
    diag_valid = np.einsum(
        "ki,ij->kij", valid_np.astype(np.float64), np.eye(ds)
    )  # per-clique identity restricted to valid slots

    def single(anc_pos, pos_nodes):
        A_eq, b_eq, A_in, lo, hi = _constraint_tensors(comp, anc_pos, dt)

        Z = jnp.zeros((K, ds, ds), dtype=dt)
        Z = Z.at[:, :d, :d].set(jnp.eye(d, dtype=dt))
        t = jnp.clip(jnp.zeros(A_in.shape[0], dtype=dt), lo, hi)
        U = (jnp.zeros((K, ds, ds), dtype=dt),
             jnp.zeros(A_in.shape[0], dtype=dt))
        # Initial rank-forcing cost: identity on the VALID slots only, so no
        # dual charge builds up against padded coordinates (see
        # _solve_sdp_admm_blocks pad_mask).
        C = jnp.asarray(diag_valid, dtype=dt)
        pm = jnp.asarray(pad_mask, dtype=dt)

        def outer(carry, _):
            Z, t, U, C, last_cost, done, feas_prev, eig_prev = carry
            Z_new, t_new, U_new, feas = _solve_sdp_admm_blocks(
                A_eq, b_eq, A_in, lo, hi, C, Z, t, U, params, pad_mask=pm
            )
            C_new, eig_sum = _fantope_blocks(
                Z_new, d, comp.member, params.eigh_sweeps
            )
            cost = jnp.sum(C * Z_new)
            change = jnp.abs(last_cost - cost)
            rel = change / jnp.maximum(jnp.abs(last_cost), 1e-30)
            new_done = done | (
                (change <= params.abs_tol)
                | (cost <= params.abs_tol)
                | (rel < params.rel_tol)
            )
            keep = lambda old, new: jnp.where(done, old, new)
            return (
                keep(Z, Z_new),
                keep(t, t_new),
                jax.tree.map(keep, U, U_new),
                keep(C, C_new),
                keep(last_cost, cost),
                new_done,
                keep(feas_prev, feas),
                keep(eig_prev, eig_sum),
            ), None

        init = (
            Z, t, U, C,
            jnp.asarray(1e6, dt),
            jnp.zeros((), bool),
            jnp.asarray(jnp.inf, dt),
            jnp.asarray(jnp.inf, dt),
        )
        (Z, t, U, C, cost, done, feas, eig_sum), _ = jax.lax.scan(
            outer, init, None, length=params.max_outer
        )

        # assemble free positions: average shared rows across cliques
        X = jnp.zeros((comp.n_free, d), dtype=dt)
        count = jnp.zeros((comp.n_free,), dtype=dt)
        for k in range(K):
            for j, u in enumerate(comp.cliques[k]):
                X = X.at[u].add(Z[k, d + j, :d])
                count = count.at[u].add(1.0)
        X = X / count[:, None]
        points = pos_nodes.at[jnp.asarray(comp.free_idx), :].set(X)
        status = jnp.where(feas <= params.feas_tol, FEASIBLE, INFEASIBLE)
        return points, status, eig_sum, feas

    fn = single
    batch = pos_all.shape[:-2]
    for _ in range(len(batch)):
        fn = jax.vmap(fn)
    with jax.default_matmul_precision("highest"):
        points, status, eig_sum, feas = fn(anchors_pos, pos_all)
        q, T_base = _extract_joints(ps, comp, points, T_goal)
    return {
        "q": q,
        "T_base": T_base,
        "points": points,
        "status": status,
        "eig_sum": eig_sum,
        "feas": feas,
    }
