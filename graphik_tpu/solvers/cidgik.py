"""CIDGIK: convex-iteration SDP relaxation of the distance program, batched.

Reimplements the reference's CIDGIK path (convex_iteration.py:160-319 +
sdp_snl.py constraint machinery) as batched array programs:

* cvxpy/MOSEK interior point -> a batched two-block ADMM over the product
  cone (PSD x box), with the affine projection factored once per instance
  (Cholesky of A A^T) and the cone projection a batched eigh.
* per-clique chordal decomposition -> the dense union clique (the default
  used by solve_with_cidgik, convex_iteration.py:296-300); N ~ 13-20 dense
  PSD matrices are trivial batched work.
* rank-d forcing via the closed-form Fantope projection C = U_{d:} U_{d:}^T
  (convex_iteration.py:43-53), batched.

Geometry of the lifted variable (sdp_snl.py:107-156):

    Z = [[ I_d , X^T ],      X in R^{n_free x d}: free node positions,
         [ X   , G   ]]      G  = X X^T at a rank-d solution.

Anchored nodes (p0, q0, goal anchors p_ee/q_ee, obstacles) enter the
constraints linearly through their (per-instance) positions; base nodes
x, y are removed entirely (convex_iteration.py:178-180).

Per-instance status codes replace exceptions: 0 = FEASIBLE, 1 = INFEASIBLE
(primal residual did not converge), mirroring utils/constants.py:20-23.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.ops.jacobi import jacobi_eigh
from graphik_tpu.ops.linalg import spd_inverse_factor

FEASIBLE = 0
INFEASIBLE = 1


@dataclasses.dataclass(eq=False)
class CidgikCompiled:
    """Static (per robot+environment) CIDGIK problem template.

    Index conventions: SDP nodes are the problem-graph nodes minus x, y.
    `free_idx` / `anchor_idx` map into the ProblemStructure node order.
    Constraint coefficient tables are dense, with per-edge node slots; the
    per-instance anchor positions are gathered inside jit.
    """

    structure: ProblemStructure
    free_idx: np.ndarray  # (n_free,) problem-node indices of free points
    anchor_idx: np.ndarray  # (n_anchor,) problem-node indices of anchors

    # equality edges (free-free): (m_ff, 2) slots into free list; b = d^2
    eq_ff: np.ndarray
    eq_ff_b: np.ndarray
    # equality edges (free-anchor): (m_fa, 2) = (free slot, anchor slot)
    eq_fa: np.ndarray
    eq_fa_d2: np.ndarray  # squared edge distance (static part; goal edges
    # are recomputed per instance from anchor positions)
    eq_fa_dynamic: np.ndarray  # bool: recompute d^2 from instance anchors

    # inequality edges: slots + box bounds (squared)
    in_ff: np.ndarray
    in_ff_lo: np.ndarray
    in_ff_hi: np.ndarray
    in_fa: np.ndarray
    in_fa_lo: np.ndarray
    in_fa_hi: np.ndarray

    # planar linear constraints n . x_u = c on free nodes (floor_mode;
    # convex_iteration.py:185-192 + sdp_snl.py add_planar_constraints,
    # sdp_snl.py:854-871). Empty unless compile_cidgik(floor_mode=True).
    lin_u: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )  # (m_l,) free slots
    lin_n: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3))
    )  # (m_l, d) plane normals
    lin_c: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0)
    )  # (m_l,) offsets

    @property
    def d(self) -> int:
        return self.structure.dim

    @property
    def n_free(self) -> int:
        return len(self.free_idx)

    @property
    def s(self) -> int:  # lifted matrix size
        return self.d + self.n_free

    @property
    def m_eq(self) -> int:
        d = self.d
        return (d * (d + 1) // 2 + len(self.lin_u) + len(self.eq_ff)
                + len(self.eq_fa))

    @property
    def m_in(self) -> int:
        return len(self.in_ff) + len(self.in_fa)


def compile_cidgik(
    ps: ProblemStructure, floor_mode: bool = False
) -> CidgikCompiled:
    """Host-side constraint assembly (sdp_snl.py:201-398 semantics).

    Supports both 3D revolute and planar problems; the planar variant drops
    the q-auxiliary nodes and anchors the end effector plus its predecessor
    (the reference's planar path, sdp_snl.py:854-871 /
    graph_planar.py:136-145).

    floor_mode (convex_iteration.py:185-192): free the base nodes p0/q0
    from anchoring and constrain them to their canonical horizontal planes
    instead - linear matrix equalities n . x_u = c with n = e_z
    (add_planar_constraints, sdp_snl.py:854-871). The base may then slide/
    yaw on the floor while the goal anchors still pin the end effector.
    """
    dim = ps.dim

    # SDP nodes: everything except x, y (convex_iteration.py:178-180)
    sdp_nodes = [i for i in range(ps.N) if i not in (ps.idx_x, ps.idx_y)]

    # anchors: statically positioned nodes (p0, q0, obstacles) + goal nodes
    anchor = set()
    for i in sdp_nodes:
        if ps.anchor_mask[i]:
            anchor.add(i)
    floor_nodes = []
    if floor_mode:
        if dim != 3:
            raise ValueError("floor_mode requires a 3D problem")
        floor_nodes = [ps.idx_p(0), ps.idx_q(0)]
        for i in floor_nodes:
            anchor.discard(i)
    free = [i for i in sdp_nodes if i not in anchor]
    anchor = sorted(anchor)
    free_slot = {node: k for k, node in enumerate(free)}
    anchor_slot = {node: k for k, node in enumerate(anchor)}

    goal_anchor = set()
    for ee in ps.template.ee:
        goal_anchor.add(ps.idx_p(int(ee)))
        if dim == 3:
            goal_anchor.add(ps.idx_q(int(ee)))
        else:
            goal_anchor.add(ps.idx_p(int(ps.template.parents[int(ee)])))

    eq_ff, eq_ff_b = [], []
    eq_fa, eq_fa_d2, eq_fa_dyn = [], [], []
    in_ff, in_ff_lo, in_ff_hi = [], [], []
    in_fa, in_fa_lo, in_fa_hi = [], [], []

    for a in range(ps.N):
        for b in range(a + 1, ps.N):
            if a not in free_slot and a not in anchor_slot:
                continue
            if b not in free_slot and b not in anchor_slot:
                continue
            both_anchor = a in anchor_slot and b in anchor_slot
            if both_anchor:
                continue  # constant constraints carry no information
            if ps.omega_struct[a, b]:
                d2 = float(ps.D_struct[a, b])
                if a in free_slot and b in free_slot:
                    eq_ff.append((free_slot[a], free_slot[b]))
                    eq_ff_b.append(d2)
                else:
                    f, anc = (a, b) if a in free_slot else (b, a)
                    dynamic = anc in goal_anchor
                    eq_fa.append((free_slot[f], anchor_slot[anc]))
                    eq_fa_d2.append(d2)
                    eq_fa_dyn.append(dynamic)
            elif ps.bounded_mask[a, b]:
                lo = float(ps.check_L[a, b]) ** 2
                hi = float(ps.check_U[a, b]) ** 2
                if a in free_slot and b in free_slot:
                    in_ff.append((free_slot[a], free_slot[b]))
                    in_ff_lo.append(lo)
                    in_ff_hi.append(hi)
                else:
                    f, anc = (a, b) if a in free_slot else (b, a)
                    in_fa.append((free_slot[f], anchor_slot[anc]))
                    in_fa_lo.append(lo)
                    in_fa_hi.append(hi)

    # floor_mode planar rows: n . x_u = c with c = n . pos_fixed[u] (the
    # canonical base pose defines each node's plane: z(p0)=0, z(q0)=1 for
    # the standard templates, matching the reference's hard-coded planes).
    lin_u, lin_n, lin_c = [], [], []
    if floor_nodes:
        pos_fixed = np.asarray(ps.pos_fixed, np.float64)
        n_vec = np.zeros(dim)
        n_vec[-1] = 1.0
        for node in floor_nodes:
            lin_u.append(free_slot[node])
            lin_n.append(n_vec.copy())
            lin_c.append(float(n_vec @ pos_fixed[node, :dim]))

    def arr(x, dtype=float):
        return np.asarray(x, dtype=dtype).reshape(len(x), -1) if len(x) else np.zeros((0, 2), dtype=dtype)

    return CidgikCompiled(
        structure=ps,
        free_idx=np.asarray(free, dtype=np.int64),
        anchor_idx=np.asarray(anchor, dtype=np.int64),
        eq_ff=arr(eq_ff, np.int64),
        eq_ff_b=np.asarray(eq_ff_b, dtype=float),
        eq_fa=arr(eq_fa, np.int64),
        eq_fa_d2=np.asarray(eq_fa_d2, dtype=float),
        eq_fa_dynamic=np.asarray(eq_fa_dyn, dtype=bool),
        in_ff=arr(in_ff, np.int64),
        in_ff_lo=np.asarray(in_ff_lo, dtype=float),
        in_ff_hi=np.asarray(in_ff_hi, dtype=float),
        in_fa=arr(in_fa, np.int64),
        in_fa_lo=np.asarray(in_fa_lo, dtype=float),
        in_fa_hi=np.asarray(in_fa_hi, dtype=float),
        lin_u=np.asarray(lin_u, dtype=np.int64),
        lin_n=(np.asarray(lin_n, dtype=float) if lin_u
               else np.zeros((0, dim))),
        lin_c=np.asarray(lin_c, dtype=float),
    )


# ---------------------------------------------------------------------------
# Constraint operator (dense batched linear algebra, no explicit A matrices)
# ---------------------------------------------------------------------------

def _constraint_matrices(comp: CidgikCompiled, anchors_pos, dtype):
    """Materialize the (m, s, s) symmetric constraint tensor + rhs/boxes.

    anchors_pos: (n_anchor, d) per-instance anchor positions.
    Returns (A_eq (m_eq,s,s), b_eq (m_eq,), A_in (m_in,s,s), lo, hi).
    """
    d = comp.d
    s = comp.s
    nf = comp.n_free

    mats = []
    rhs = []

    # identity block: Z[i, j] = delta_ij for i <= j < d (sdp_snl.py:140-156)
    for i in range(d):
        for j in range(i, d):
            A = np.zeros((s, s))
            A[i, j] += 0.5
            A[j, i] += 0.5
            mats.append(A)
            rhs.append(1.0 if i == j else 0.0)
    # floor_mode planar rows: tr(A Z) = n . x_u = c (sdp_snl.py:854-871)
    for k in range(len(comp.lin_u)):
        u = int(comp.lin_u[k])
        A = np.zeros((s, s))
        A[d + u, :d] = 0.5 * comp.lin_n[k]
        A[:d, d + u] = 0.5 * comp.lin_n[k]
        mats.append(A)
        rhs.append(float(comp.lin_c[k]))
    A_id = jnp.asarray(np.stack(mats), dtype=dtype)
    b_id = jnp.asarray(np.asarray(rhs), dtype=dtype)

    def ff_mats(pairs):
        out = np.zeros((len(pairs), s, s))
        for k, (u, v) in enumerate(pairs):
            out[k, d + u, d + u] = 1.0
            out[k, d + v, d + v] = 1.0
            out[k, d + u, d + v] = -1.0
            out[k, d + v, d + u] = -1.0
        return out

    def fa_mats(pairs, anchors_pos):
        # G_uu - 2 a^T X_u  (the ||a||^2 constant moves to the rhs)
        m = len(pairs)
        out = jnp.zeros((m, s, s), dtype=dtype)
        if m == 0:
            return out
        u = jnp.asarray(pairs[:, 0])
        asl = jnp.asarray(pairs[:, 1])
        a_pos = anchors_pos[asl]  # (m, d)
        out = out.at[jnp.arange(m), d + u, d + u].set(1.0)
        out = out.at[jnp.arange(m)[:, None], d + u[:, None], jnp.arange(d)[None, :]].set(
            -a_pos
        )
        out = out.at[jnp.arange(m)[:, None], jnp.arange(d)[None, :], d + u[:, None]].set(
            -a_pos
        )
        return out

    A_eq_parts = [A_id]
    b_eq_parts = [b_id]
    if len(comp.eq_ff):
        A_eq_parts.append(jnp.asarray(ff_mats(comp.eq_ff), dtype=dtype))
        b_eq_parts.append(jnp.asarray(comp.eq_ff_b, dtype=dtype))
    if len(comp.eq_fa):
        A_fa = fa_mats(comp.eq_fa, anchors_pos)
        A_eq_parts.append(A_fa)
        asl = jnp.asarray(comp.eq_fa[:, 1])
        a_norm2 = jnp.sum(anchors_pos[asl] ** 2, axis=-1)
        d2_static = jnp.asarray(comp.eq_fa_d2, dtype=dtype)
        # dynamic goal edges: recompute the edge length from instance anchors?
        # Structure edges touching goal anchors keep their static rigid
        # length (the goal only moves the anchor), so d2_static is correct
        # for all of them; b = d^2 - ||a||^2.
        b_eq_parts.append(d2_static - a_norm2)
    A_eq = jnp.concatenate(A_eq_parts, axis=0)
    b_eq = jnp.concatenate(b_eq_parts, axis=0)

    A_in_parts = []
    lo_parts = []
    hi_parts = []
    if len(comp.in_ff):
        A_in_parts.append(jnp.asarray(ff_mats(comp.in_ff), dtype=dtype))
        lo_parts.append(jnp.asarray(comp.in_ff_lo, dtype=dtype))
        hi_parts.append(jnp.asarray(comp.in_ff_hi, dtype=dtype))
    if len(comp.in_fa):
        A_in_parts.append(fa_mats(comp.in_fa, anchors_pos))
        asl = jnp.asarray(comp.in_fa[:, 1])
        a_norm2 = jnp.sum(anchors_pos[asl] ** 2, axis=-1)
        lo_parts.append(jnp.asarray(comp.in_fa_lo, dtype=dtype) - a_norm2)
        hi_parts.append(jnp.asarray(comp.in_fa_hi, dtype=dtype) - a_norm2)
    if A_in_parts:
        A_in = jnp.concatenate(A_in_parts, axis=0)
        lo = jnp.concatenate(lo_parts, axis=0)
        hi = jnp.concatenate(hi_parts, axis=0)
    else:
        A_in = jnp.zeros((0, s, s), dtype=dtype)
        lo = jnp.zeros((0,), dtype=dtype)
        hi = jnp.zeros((0,), dtype=dtype)

    # SCS-style row normalization: unit-Frobenius constraint matrices keep
    # the ADMM operator well conditioned across edge length scales.
    def rownorm(A):
        return jnp.sqrt(jnp.maximum(jnp.sum(A * A, axis=(-2, -1)), 1e-12))

    n_eq = rownorm(A_eq)
    A_eq = A_eq / n_eq[:, None, None]
    b_eq = b_eq / n_eq
    if A_in.shape[0]:
        n_in = rownorm(A_in)
        A_in = A_in / n_in[:, None, None]
        lo = lo / n_in
        hi = hi / n_in
    return A_eq, b_eq, A_in, lo, hi


# ---------------------------------------------------------------------------
# Batched conic ADMM:  min <C,Z>  s.t. A_eq(Z)=b, lo <= A_in(Z) <= hi, Z >= 0
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CidgikParams:
    max_outer: int = 10  # convex-iteration budget (convex_iteration.py:164)
    admm_iters: int = 2000  # per SDP solve (cap; stops early on admm_tol)
    # Iteration budget for the FIRST convex-iteration round only (None =
    # admm_iters). Warm-started later rounds start from the previous
    # round's primal/dual point and converge in a fraction of the cold
    # first solve's iterations, so a (long, short) schedule buys ~2x
    # wall at equal polished accuracy (split engine only).
    admm_iters_rest: Optional[int] = None
    admm_tol: float = 1e-7  # primal-dual residual target per solve
    relax: float = 1.6  # ADMM over-relaxation
    rho: float = 1.0  # ADMM penalty
    abs_tol: float = 1e-6  # eig-sum/cost tolerances (convex_iteration.py:169-171)
    rel_tol: float = 1e-3
    feas_tol: float = 1e-4  # primal residual -> FEASIBLE/INFEASIBLE
    # Eigendecomposition backend for the cone/Fantope projections:
    # fixed-sweep Jacobi (ops/jacobi.py) keeps the compiled program tiny -
    # XLA's iterative eigh inside while x scan x vmap compiled far slower.
    # 0 = use jnp.linalg.eigh.
    eigh_sweeps: int = 8
    # PSD cone projection backend for the per-ADMM-iteration projection:
    # >0 switches from the Jacobi eigendecomposition (~120 sequential
    # scatter-heavy rotation rounds per call) to that many Newton-Schulz
    # matrix-sign iterations (ops/linalg.psd_project_ns) - pure batched
    # (s, s) matmuls. The Fantope projection (once per OUTER
    # round) needs actual eigenvectors and always uses eigh.
    cone_ns_iters: int = 0
    # Iterative-refinement steps for the affine-projection Cholesky solve.
    # In float32 the ~90x90 constraint Gram is ill-conditioned enough that
    # the raw solve biases the ADMM fixed point by ~cm; one refinement step
    # recovers near-f64 solve quality at ~2x the solve cost.
    refine_steps: int = 1
    # Residual-balancing rho adaptation (Boyd et al. sec 3.4.1): when the
    # primal residual exceeds adapt_mu x the dual residual, multiply rho by
    # adapt_tau and rescale the scaled duals (and vice versa). 0 disables
    # (default: on this problem family unbounded growth of rho drowns the
    # linear rank-forcing cost C/rho and stalls the convex iteration, so
    # adaptation is opt-in and rho is clipped to [adapt_lo, adapt_hi]).
    adapt_every: int = 0
    adapt_mu: float = 10.0
    adapt_tau: float = 2.0
    adapt_lo: float = 0.3
    adapt_hi: float = 3.0

    @classmethod
    def production(cls, **overrides) -> "CidgikParams":
        """The tuned serving operating point (an f32 accuracy sweep).

        rho is the dominant raw-accuracy lever on this problem family:
        with the row-normalized operator, rho=10 lifted the raw (un-
        polished) ADMM rate @1cm well above rho=1 on dense UR10 and on the
        100-sphere table scene at IDENTICAL per-iteration cost, past the
        f64 oracle rate measured at rho=1 (PARITY.md, f64 CPU). Past
        rho~12 the @1cm rate keeps inching up
        but @1mm regresses (the rank-forcing cost C/rho gets too weak to
        finish driving the small eigenvalues), so production sits at the
        combined-accuracy optimum. The (1000, 9x500) warm-start schedule
        and the Newton-Schulz cone projection are the round-4 tuning.
        (The admm_tol early stop is left at the conservative default: at
        rho=10 the batched max-over-lanes primal residual stays above
        3e-5 for the full budget at B=1024, so no tol in that range ever
        fires - measured round 5, bench config walls unchanged.)
        """
        kw = dict(admm_iters=1000, admm_iters_rest=500, max_outer=10,
                  cone_ns_iters=16, rho=10.0)
        kw.update(overrides)
        return cls(**kw)


def _solve_sdp_admm(A_eq, b_eq, A_in, lo, hi, C, Z0, s0, u0, params):
    """One linear-cost SDP solve via two-block ADMM (single instance).

    Splitting: P = (Z, t) with the affine set {A_eq(Z)=b, A_in(Z)-t=0} and
    the cone set PSD x [lo, hi]. The affine projection uses a Cholesky of
    the constraint Gram matrix, computed once per call.
    """
    m_eq = A_eq.shape[0]
    m_in = A_in.shape[0]
    s = A_eq.shape[-1]
    rho = params.rho

    # Gram of the combined operator Abar(Z, t) = [A_eq(Z); A_in(Z) - t]
    A_all = jnp.concatenate([A_eq, A_in], axis=0)  # (m, s, s)
    Gmm = jnp.einsum("mij,nij->mn", A_all, A_all)
    if m_in:
        Gmm = Gmm.at[m_eq:, m_eq:].add(jnp.eye(m_in, dtype=Gmm.dtype))
    Gmm = Gmm + 1e-9 * jnp.trace(Gmm) / Gmm.shape[0] * jnp.eye(
        Gmm.shape[0], dtype=Gmm.dtype
    )
    # Explicit inverse factor: lax.linalg.cholesky's internal matmuls are
    # outside default_matmul_precision (float32 may run in TF32), which
    # corrupts the affine projection; spd_inverse_factor uses explicit
    # HIGHEST-precision dots (ops/linalg.py).
    Linv = spd_inverse_factor(Gmm)
    hp = jax.lax.Precision.HIGHEST

    def solve_gram(r):
        def apply_inv(v):
            return jnp.matmul(
                jnp.swapaxes(Linv, -1, -2),
                jnp.matmul(Linv, v, precision=hp), precision=hp,
            )

        y = apply_inv(r)
        for _ in range(params.refine_steps):
            y = y + apply_inv(r - jnp.matmul(Gmm, y, precision=hp))
        return y

    def affine_project(Z, t):
        r = jnp.concatenate(
            [jnp.einsum("mij,ij->m", A_eq, Z) - b_eq,
             jnp.einsum("mij,ij->m", A_in, Z) - t]
            if m_in
            else [jnp.einsum("mij,ij->m", A_eq, Z) - b_eq]
        )
        y = solve_gram(r)
        Z_new = Z - jnp.einsum("m,mij->ij", y, A_all)
        t_new = t + y[m_eq:] if m_in else t
        return Z_new, t_new

    def cone_project(W, t):
        if params.cone_ns_iters:
            from graphik_tpu.ops.linalg import psd_project_ns

            Wp = psd_project_ns(W, iters=params.cone_ns_iters)
        elif params.eigh_sweeps:
            lam, Q = jacobi_eigh(W, sweeps=params.eigh_sweeps)
            lam = jnp.maximum(lam, 0.0)
            Wp = (Q * lam[None, :]) @ Q.T
        else:
            lam, Q = jnp.linalg.eigh(W)
            lam = jnp.maximum(lam, 0.0)
            Wp = (Q * lam[None, :]) @ Q.T
        tp = jnp.clip(t, lo, hi) if m_in else t
        return Wp, tp

    alpha = params.relax  # over-relaxation
    dt = Z0.dtype

    def cond(carry):
        Z, t, Uz, ut, rho_c, k, res = carry
        return (res > params.admm_tol) & (k < params.admm_iters)

    def body(carry):
        Z, t, Uz, ut, rho_c, k, _ = carry
        # prox of <C,Z> + affine indicator at (W - U): shift by C/rho, project
        Z1, t1 = affine_project(Z - Uz - C / rho_c, t - ut)
        # over-relaxed cone projection
        Zr = alpha * Z1 + (1.0 - alpha) * Z
        tr = alpha * t1 + (1.0 - alpha) * t
        Z2, t2 = cone_project(Zr + Uz, tr + ut)
        Uz_new = Uz + Zr - Z2
        ut_new = ut + tr - t2
        pri = jnp.sqrt(
            jnp.sum((Z1 - Z2) ** 2) + (jnp.sum((t1 - t2) ** 2) if m_in else 0.0)
        )
        dua = rho_c * jnp.sqrt(
            jnp.sum((Z2 - Z) ** 2) + (jnp.sum((t2 - t) ** 2) if m_in else 0.0)
        )
        if params.adapt_every:
            # residual balancing (Boyd et al. 3.4.1); scaled duals rescale
            # with 1/rho so the unscaled dual variable is continuous.
            up = pri > params.adapt_mu * dua
            down = dua > params.adapt_mu * pri
            fire = (k % params.adapt_every == params.adapt_every - 1) & (
                up | down
            )
            scale = jnp.where(up, params.adapt_tau,
                              1.0 / params.adapt_tau).astype(dt)
            # Clip only when an adaptation actually fires: a user-supplied
            # rho outside [adapt_lo, adapt_hi] must not be silently snapped
            # into the band on iteration 1.
            rho_new = jnp.where(
                fire,
                jnp.clip(rho_c * scale, params.adapt_lo, params.adapt_hi),
                rho_c,
            )
            adj = rho_c / rho_new
            Uz_new = Uz_new * adj
            ut_new = ut_new * adj
        else:
            rho_new = rho_c
        return (Z2, t2, Uz_new, ut_new, rho_new, k + 1, pri)

    init = (Z0, s0, u0[0], u0[1], jnp.asarray(rho, dt),
            jnp.zeros((), jnp.int32), jnp.asarray(jnp.inf, dt))
    Z, t, Uz, ut, _, _, _ = jax.lax.while_loop(cond, body, init)

    # primal feasibility of the returned cone-feasible iterate
    r_eq = jnp.einsum("mij,ij->m", A_eq, Z) - b_eq
    feas = jnp.max(jnp.abs(r_eq)) if m_eq else jnp.zeros((), Z.dtype)
    if m_in:
        v = jnp.einsum("mij,ij->m", A_in, Z)
        feas = jnp.maximum(
            feas, jnp.max(jnp.maximum(lo - v, 0.0) + jnp.maximum(v - hi, 0.0))
        )
    return Z, t, (Uz, ut), feas


# ---------------------------------------------------------------------------
# Split (static/dynamic) batched ADMM engine
#
# Everything in the constraint set except the ~8 rows touching the GOAL
# anchors is identical across the batch: the homogenizing identity block,
# free-free structure edges, base-anchor edges (p0/q0 positions are fixed)
# and every obstacle inequality (obstacle centers are compile-time
# constants). Splitting rows into a shared STATIC block and a tiny
# per-instance DYNAMIC block turns the per-iteration work into
# shared-weight (m_s, m_s) / (m_s, s^2) matmuls over the batch -
# shapes - and replaces the per-instance (m, m) Gram factorization with a
# host-precomputed float64 Cholesky plus an m_d x m_d Schur complement
# per instance. The vmapped per-instance engine above remains as the
# oracle path (and backs solve_nearest_point_sdp).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _SplitOperator:
    """Host-side (numpy, float64) static data for the split ADMM."""

    # static rows, ordered [eq_s | in_s], row-normalized
    A_flat: np.ndarray  # (m_s, s*s)
    b_eq_s: np.ndarray  # (m_eq_s,)
    lo_s: np.ndarray  # (m_in_s,)
    hi_s: np.ndarray  # (m_in_s,)
    G_ss: np.ndarray  # (m_s, m_s) static Gram (+ slack identity on in rows)
    Linv_ss: np.ndarray  # inverse Cholesky factor: G_ss^-1 = Linv^T Linv
    As_diag: np.ndarray  # (m_s, nf): A_i[d+u, d+u]
    As_rowvec: np.ndarray  # (m_s, nf, d): A_i[d+u, :d]
    # dynamic rows, ordered [eq_d | in_d] (raw, normalized at runtime)
    u_d: np.ndarray  # (m_d,) free slots
    g_d: np.ndarray  # (m_d,) anchor slots (goal anchors)
    d2_d: np.ndarray  # (m_d,) squared edge length (eq rows; 0 on in rows)
    lo_d: np.ndarray  # (m_d,) raw bounds (in rows; 0 on eq rows)
    hi_d: np.ndarray
    m_eq_d: int
    m_in_d: int

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
        return len(self.u_d)


def _build_split_operator(comp: CidgikCompiled) -> _SplitOperator:
    """Assemble the static/dynamic split (cached on the compiled problem)."""
    cached = getattr(comp, "_split_op", None)
    if cached is not None:
        return cached
    ps = comp.structure
    d = comp.d
    s = comp.s
    nf = comp.n_free
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

    def ff_mat(u, v):
        A = np.zeros((s, s))
        A[d + u, d + u] = 1.0
        A[d + v, d + v] = 1.0
        A[d + u, d + v] = -1.0
        A[d + v, d + u] = -1.0
        return A

    def fa_mat(u, a):
        A = np.zeros((s, s))
        A[d + u, d + u] = 1.0
        A[d + u, :d] = -a
        A[:d, d + u] = -a
        return A

    eq_mats, eq_b = [], []
    for i in range(d):
        for j in range(i, d):
            A = np.zeros((s, s))
            A[i, j] += 0.5
            A[j, i] += 0.5
            eq_mats.append(A)
            eq_b.append(1.0 if i == j else 0.0)
    # floor_mode planar rows are batch-static (plane normal/offset are
    # compile-time constants): n . x_u = c
    for k in range(len(comp.lin_u)):
        u = int(comp.lin_u[k])
        A = np.zeros((s, s))
        A[d + u, :d] = 0.5 * comp.lin_n[k]
        A[:d, d + u] = 0.5 * comp.lin_n[k]
        eq_mats.append(A)
        eq_b.append(float(comp.lin_c[k]))
    for k in range(len(comp.eq_ff)):
        u, v = comp.eq_ff[k]
        eq_mats.append(ff_mat(u, v))
        eq_b.append(comp.eq_ff_b[k])
    dyn = []  # (u, g, d2, lo, hi, is_eq)
    for k in range(len(comp.eq_fa)):
        u, g = comp.eq_fa[k]
        if anchor_is_goal[g]:
            dyn.append((u, g, comp.eq_fa_d2[k], 0.0, 0.0, True))
        else:
            a = anc_pos[g, :d]
            eq_mats.append(fa_mat(u, a))
            eq_b.append(comp.eq_fa_d2[k] - a @ a)

    in_mats, in_lo, in_hi = [], [], []
    for k in range(len(comp.in_ff)):
        u, v = comp.in_ff[k]
        in_mats.append(ff_mat(u, v))
        in_lo.append(comp.in_ff_lo[k])
        in_hi.append(comp.in_ff_hi[k])
    for k in range(len(comp.in_fa)):
        u, g = comp.in_fa[k]
        if anchor_is_goal[g]:
            dyn.append((u, g, 0.0, comp.in_fa_lo[k], comp.in_fa_hi[k], False))
        else:
            a = anc_pos[g, :d]
            in_mats.append(fa_mat(u, a))
            in_lo.append(comp.in_fa_lo[k] - a @ a)
            in_hi.append(comp.in_fa_hi[k] - a @ a)

    A_s = np.stack(eq_mats + in_mats)  # (m_s, s, s)
    m_eq_s = len(eq_mats)
    m_in_s = len(in_mats)
    nrm = np.sqrt(np.maximum((A_s**2).sum(axis=(1, 2)), 1e-12))
    A_s = A_s / nrm[:, None, None]
    b_eq_s = np.asarray(eq_b) / nrm[:m_eq_s]
    lo_s = np.asarray(in_lo) / nrm[m_eq_s:] if m_in_s else np.zeros(0)
    hi_s = np.asarray(in_hi) / nrm[m_eq_s:] if m_in_s else np.zeros(0)

    A_flat = A_s.reshape(len(A_s), s * s)
    G_ss = A_flat @ A_flat.T
    if m_in_s:
        G_ss[m_eq_s:, m_eq_s:] += np.eye(m_in_s)
    G_ss += 1e-9 * np.trace(G_ss) / len(G_ss) * np.eye(len(G_ss))
    L = np.linalg.cholesky(G_ss)
    Linv_ss = np.linalg.inv(L)

    ui = d + np.arange(nf)
    As_diag = A_s[:, ui, ui]  # (m_s, nf)
    As_rowvec = A_s[:, ui, :d]  # (m_s, nf, d)

    dyn_eq = [t for t in dyn if t[5]]
    dyn_in = [t for t in dyn if not t[5]]
    dyn = dyn_eq + dyn_in
    op = _SplitOperator(
        A_flat=A_flat,
        b_eq_s=b_eq_s,
        lo_s=lo_s,
        hi_s=hi_s,
        G_ss=G_ss,
        Linv_ss=Linv_ss,
        As_diag=As_diag,
        As_rowvec=As_rowvec,
        u_d=np.asarray([t[0] for t in dyn], np.int64),
        g_d=np.asarray([t[1] for t in dyn], np.int64),
        d2_d=np.asarray([t[2] for t in dyn], np.float64),
        lo_d=np.asarray([t[3] for t in dyn], np.float64),
        hi_d=np.asarray([t[4] for t in dyn], np.float64),
        m_eq_d=len(dyn_eq),
        m_in_d=len(dyn_in),
    )
    comp._split_op = op
    return op


def _solve_sdp_admm_split(op: _SplitOperator, aux, C, Z0, t0, U0, params,
                          d: int):
    """Batched linear-cost SDP solve over the split operator.

    aux: dict of per-instance dynamic-row data from _split_aux.
    Z0 (B, s, s), t0 (B, m_in), U0 = (Uz (B, s, s), ut (B, m_in)),
    C (B, s, s). Returns (Z, t, U, feas) batched.
    """
    dt = Z0.dtype
    B = Z0.shape[0]
    s = Z0.shape[-1]
    m_s = op.m_s
    m_eq_s = op.m_eq_s
    m_in_s = op.m_in_s
    m_d = op.m_d
    m_eq_d = op.m_eq_d
    m_in_d = op.m_in_d
    m_in = m_in_s + m_in_d
    hp = jax.lax.Precision.HIGHEST

    A_flat = jnp.asarray(op.A_flat, dt)  # (m_s, s*s)
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
    u_d = jnp.asarray(op.u_d)
    a_d = aux["a_d"]  # (B, m_d, d)
    nrm_d = aux["nrm_d"]  # (B, m_d)
    b_d = aux["b_d"]  # (B, m_d): eq rhs on eq rows, 0 on in rows
    G_sd = aux["G_sd"]  # (B, m_s, m_d)
    Ls_schur = aux["Ls_schur"]  # (B, m_d, m_d) chol of Schur complement
    G_dd = aux["G_dd"]

    Sinv = aux["Sinv"]

    def gss_inv(r):  # (B, m_s) -> (B, m_s)
        # two triangular-factor matmuls, shared weights over the batch
        z = jnp.einsum("ij,bj->bi", Linv, r, precision=hp)
        return jnp.einsum("ji,bj->bi", Linv, z, precision=hp)

    def schur_solve(r):  # (B, m_d): fusable multiply-reduce vs 2*m_d
        # sequential substitution steps (dispatch-latency-bound)
        return jnp.sum(Sinv * r[:, None, :], axis=-1)

    def apply_A(Z, t):
        """Full residual r = [A(Z) - b; A_in(Z) - t], ordered
        [eq_s | in_s | eq_d | in_d] -> returns (r_s (B, m_s), r_d (B, m_d))."""
        Zf = Z.reshape(B, s * s)
        v_s = jnp.einsum("ms,bs->bm", A_flat, Zf, precision=hp)
        r_s = v_s.at[:, :m_eq_s].add(-b_eq_s)
        if m_in_s:
            r_s = r_s.at[:, m_eq_s:].add(-t[:, :m_in_s])
        if m_d:
            diag_v = Z[:, d + u_d, d + u_d]  # (B, m_d)
            row_v = Z[:, d + u_d, :d]  # (B, m_d, d)
            v_d = (diag_v - 2.0 * jnp.sum(a_d * row_v, axis=-1)) / nrm_d
            r_d = v_d - b_d
            if m_in_d:
                r_d = r_d.at[:, m_eq_d:].add(-t[:, m_in_s:])
        else:
            r_d = jnp.zeros((B, 0), dt)
        return r_s, r_d

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
            # residual of the full Gram system, then one more solve
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
        """dZ = sum_m y_m A_m and the slack part dt = +y on in rows."""
        Zc = jnp.einsum("ms,bm->bs", A_flat, y_s, precision=hp).reshape(
            B, s, s
        )
        if m_d:
            w = y_d / nrm_d
            Zc = Zc.at[:, d + u_d, d + u_d].add(w)
            Zc = Zc.at[:, d + u_d, :d].add(-w[..., None] * a_d)
            Zc = Zc.at[:, :d, d + u_d].add(
                jnp.swapaxes(-w[..., None] * a_d, 1, 2)
            )
        parts = []
        if m_in_s:
            parts.append(y_s[:, m_eq_s:])
        if m_in_d:
            parts.append(y_d[:, m_eq_d:])
        dt_vec = (jnp.concatenate(parts, axis=1) if parts
                  else jnp.zeros((B, 0), dt))
        return Zc, dt_vec

    def affine_project(Z, t):
        r_s, r_d = apply_A(Z, t)
        y_s, y_d = solve_gram(r_s, r_d)
        dZ, dt_vec = adjoint(y_s, y_d)
        return Z - dZ, t + dt_vec

    def cone_project(W, t):
        if params.cone_ns_iters:
            from graphik_tpu.ops.linalg import psd_project_ns

            # unroll=True: broadcast-FMA matmuls fuse across the NS chain
            # (the standalone batched-matmul ops were launch-latency
            # bound; see ops/linalg.mm_unrolled)
            Wp = psd_project_ns(W, iters=params.cone_ns_iters, unroll=True)
        elif params.eigh_sweeps:
            lam, Q = jacobi_eigh(W, sweeps=params.eigh_sweeps)
            lam = jnp.maximum(lam, 0.0)
            Wp = jnp.einsum("bik,bk,bjk->bij", Q, lam, Q)
        else:
            lam, Q = jnp.linalg.eigh(W)
            lam = jnp.maximum(lam, 0.0)
            Wp = jnp.einsum("bik,bk,bjk->bij", Q, lam, Q)
        tp = jnp.clip(t, lo, hi) if m_in else t
        return Wp, tp

    alpha = params.relax
    rho = params.rho

    def cond(carry):
        Z, t, Uz, ut, k, res = carry
        return (jnp.max(res) > params.admm_tol) & (k < params.admm_iters)

    def body(carry):
        Z, t, Uz, ut, k, _ = carry
        Z1, t1 = affine_project(Z - Uz - C / rho, t - ut)
        Zr = alpha * Z1 + (1.0 - alpha) * Z
        tr = alpha * t1 + (1.0 - alpha) * t
        Z2, t2 = cone_project(Zr + Uz, tr + ut)
        Uz_new = Uz + Zr - Z2
        ut_new = ut + tr - t2
        pri = jnp.sqrt(
            jnp.sum((Z1 - Z2) ** 2, axis=(-2, -1))
            + (jnp.sum((t1 - t2) ** 2, axis=-1) if m_in else 0.0)
        )
        return (Z2, t2, Uz_new, ut_new, k + 1, pri)

    init = (Z0, t0, U0[0], U0[1], jnp.zeros((), jnp.int32),
            jnp.full((B,), jnp.inf, dt))
    Z, t, Uz, ut, _, _ = jax.lax.while_loop(cond, body, init)

    # primal feasibility of the returned cone-feasible iterate: with t = 0,
    # apply_A returns raw constraint values (b subtracted on eq rows only)
    v_s, v_d = apply_A(Z, jnp.zeros_like(t))
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


def _split_aux(op: _SplitOperator, anchors_pos, params, dt):
    """Per-instance dynamic-row data + Schur factor (once per solve)."""
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

    u_d = np.asarray(op.u_d)
    Asd_diag = jnp.asarray(op.As_diag[:, u_d], dt)  # (m_s, m_d)
    Asd_vec = jnp.asarray(op.As_rowvec[:, u_d, :], dt)  # (m_s, m_d, d)
    G_sd = (
        Asd_diag[None] - 2.0 * jnp.einsum(
            "bjk,ijk->bij", a_d, Asd_vec, precision=hp
        )
    ) / nrm_d[:, None, :]

    same_u = jnp.asarray(u_d[:, None] == u_d[None, :], dt)
    G_dd = same_u * (
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
    # Explicit Schur inverse: turns the two in-loop triangular
    # substitution chains (2*m_d sequential tiny ops each) into single
    # fusable multiply-reduces (see the sparse engine, cidgik_sparse.py).
    from graphik_tpu.ops.linalg import chol_solve_unrolled as _csu

    eye_md = jnp.eye(m_d, dtype=dt)
    Sinv = jax.vmap(
        lambda e: _csu(Ls_schur, jnp.broadcast_to(e, (B, m_d))),
        out_axes=-1,
    )(eye_md)
    return {
        "a_d": a_d, "nrm_d": nrm_d, "b_d": b_d,
        "lo_d": lo_d, "hi_d": hi_d,
        "G_sd": G_sd, "G_dd": G_dd, "Ls_schur": Ls_schur,
        "Sinv": Sinv,
    }


def _fantope(Z, d, eigh_sweeps: int = 8):
    """Closed-form Fantope projection C = U_{d:} U_{d:}^T
    (convex_iteration.py:43-53) and the excess-rank eigenvalue sum."""
    if eigh_sweeps:
        lam, Q = jacobi_eigh(Z, sweeps=eigh_sweeps)  # ascending
    else:
        lam, Q = jnp.linalg.eigh(Z)  # ascending
    n_small = Z.shape[-1] - d
    U = Q[..., :n_small]  # all but the top-d eigenvectors
    C = U @ jnp.swapaxes(U, -1, -2)
    eig_sum = jnp.sum(lam[..., :n_small], axis=-1)
    return C, eig_sum


def realign_floor_solution(ps, points, T_goal):
    """Gauge realignment for floor_mode solutions (batched, jittable).

    floor_mode frees the base nodes p0/q0 onto horizontal planes
    (reference convex_iteration.py:185-192), so a solved point set carries
    an arbitrary rigid base displacement: a slide + yaw on the floor.
    ``ProblemStructure.joint_variables`` assumes the canonical anchored
    base frame, so before joint extraction the solution must be
    re-expressed in its own solved base frame: origin at the solved p0,
    z-axis along (q0 - p0), and a deterministic horizontal x-axis — the
    yaw freedom is absorbed by the first joint angle for robots whose
    joint-1 axis is the base z (every reference robot). The goal pose is
    mapped by the same base pose, and T_base is returned so world-frame
    FK of the extracted q is ``T_base @ fk(q)``.

    points : (..., N, d=3) solved node positions (world/solved frame)
    T_goal : (..., 4, 4) goal poses in the same frame

    Returns (points_base, T_goal_base, T_base) with T_base (..., 4, 4).
    """
    ip0, iq0 = int(ps.idx_p(0)), int(ps.idx_q(0))
    ix, iy = int(ps.idx_x), int(ps.idx_y)
    p0 = points[..., ip0, :]
    q0 = points[..., iq0, :]
    z = q0 - p0
    z = z / jnp.linalg.norm(z, axis=-1, keepdims=True)
    # Deterministic horizontal reference: e_x unless nearly parallel to z.
    ex = jnp.zeros_like(z).at[..., 0].set(1.0)
    ey = jnp.zeros_like(z).at[..., 1].set(1.0)
    r = jnp.where(jnp.abs(z[..., :1]) > 0.9, ey, ex)
    x = r - jnp.sum(r * z, axis=-1, keepdims=True) * z
    x = x / jnp.linalg.norm(x, axis=-1, keepdims=True)
    y = jnp.cross(z, x)
    R = jnp.stack([x, y, z], axis=-1)  # columns = base axes in world frame
    P = jnp.einsum("...nk,...kj->...nj", points - p0[..., None, :], R)
    pos_fixed = jnp.asarray(ps.pos_fixed, points.dtype)
    P = P.at[..., ix, :].set(pos_fixed[ix])
    P = P.at[..., iy, :].set(pos_fixed[iy])
    T_base = jnp.zeros(points.shape[:-2] + (4, 4), points.dtype)
    T_base = (
        T_base.at[..., :3, :3].set(R)
        .at[..., :3, 3].set(p0)
        .at[..., 3, 3].set(1.0)
    )
    # Rigid inverse of T_base applied to T_goal. T_goal may carry extra
    # trailing batch axes relative to points (e.g. a per-end-effector axis
    # from api.random_goals): broadcast the per-instance base pose across
    # them.
    bd = points.shape[:-2]
    extra = T_goal.ndim - 2 - len(bd)
    Rt = jnp.swapaxes(R, -1, -2).reshape(bd + (1,) * extra + (3, 3))
    p0b = p0.reshape(bd + (1,) * extra + (3,))
    Rg = T_goal[..., :3, :3].astype(points.dtype)
    tg = T_goal[..., :3, 3].astype(points.dtype)
    Tg = jnp.zeros(T_goal.shape[:-2] + (4, 4), points.dtype)
    Tg = (
        Tg.at[..., :3, :3].set(Rt @ Rg)
        .at[..., :3, 3].set(
            jnp.einsum("...ij,...j->...i", Rt, tg - p0b)
        )
        .at[..., 3, 3].set(1.0)
    )
    return P, Tg, T_base


def _extract_joints(ps, comp, points, T_goal):
    """joint_variables with the floor_mode gauge fix applied when needed.

    Returns (q, T_base); T_base is the identity for anchored problems so
    the solve output schema is stable across compilations.
    """
    if len(comp.lin_u):
        P, Tg, T_base = realign_floor_solution(ps, points, T_goal)
        return ps.joint_variables(P, Tg), T_base
    T_base = jnp.zeros(points.shape[:-2] + (4, 4), points.dtype)
    T_base = (
        T_base.at[..., 0, 0].set(1.0).at[..., 1, 1].set(1.0)
        .at[..., 2, 2].set(1.0).at[..., 3, 3].set(1.0)
    )
    return ps.joint_variables(points, T_goal), T_base


def nearest_point_cost_matrix(comp: CidgikCompiled, targets, dtype=None):
    """Linear cost C with tr(C Z) = sum_u (G_uu - 2 p_u^T x_u).

    Up to the constant sum ||p_u||^2 this is the nearest-point objective
    sum_u ||x_u - p_u||^2 (reference sdp_snl.py:417-445 cost map).
    targets: (..., n_free, d).
    """
    targets = jnp.asarray(targets, dtype=dtype)
    dt = targets.dtype
    d = comp.d
    s = comp.s
    nf = comp.n_free
    batch = targets.shape[:-2]
    C = jnp.zeros(batch + (s, s), dt)
    C = C.at[..., d:, d:].add(jnp.eye(nf, dtype=dt))
    C = C.at[..., d:, :d].add(-targets)
    C = C.at[..., :d, d:].add(-jnp.swapaxes(targets, -1, -2))
    return C


def solve_nearest_point_sdp(
    comp: CidgikCompiled,
    anchors_pos,
    targets,
    params: CidgikParams = CidgikParams(),
    ranges: bool = False,
    dtype=None,
):
    """Nearest-point SDP: project target points onto the constraint set.

    The reference's second SDP entry point (`solve_nearest_point_sdp`,
    sdp_snl.py:810-851): a single linear-cost SDP (no convex iteration)
    minimizing sum_u ||x_u - p_u||^2 subject to the distance equalities
    (and, with ranges=True, the bound inequalities).

    anchors_pos: (..., n_anchor, d); targets: (..., n_free, d); leading
    dims batch. Returns dict(points (..., n_free, d), Z, feas).
    """
    anchors_pos = jnp.asarray(anchors_pos, dtype=dtype)
    dt = anchors_pos.dtype
    targets = jnp.asarray(targets, dtype=dt)
    d = comp.d
    s = comp.s

    def single(anc_pos, tgt):
        A_eq, b_eq, A_in, lo, hi = _constraint_matrices(comp, anc_pos, dt)
        if not ranges:
            A_in = A_in[:0]
            lo = lo[:0]
            hi = hi[:0]
        C = nearest_point_cost_matrix(comp, tgt)
        Z = jnp.zeros((s, s), dtype=dt).at[:d, :d].set(jnp.eye(d, dtype=dt))
        Z = Z.at[d:, :d].set(tgt)
        Z = Z.at[:d, d:].set(tgt.T)
        Z = Z.at[d:, d:].set(tgt @ tgt.T)
        t = jnp.clip(
            jnp.einsum("mij,ij->m", A_in, Z), lo, hi
        ) if A_in.shape[0] else jnp.zeros((0,), dt)
        U = (jnp.zeros((s, s), dtype=dt), jnp.zeros(A_in.shape[0], dtype=dt))
        Z_out, _, _, feas = _solve_sdp_admm(
            A_eq, b_eq, A_in, lo, hi, C, Z, t, U, params
        )
        return Z_out, feas

    fn = single
    batch = anchors_pos.shape[:-2]
    for _ in range(len(batch)):
        fn = jax.vmap(fn)
    with jax.default_matmul_precision("highest"):
        Z, feas = fn(anchors_pos, targets)
    return {"points": Z[..., d:, :d], "Z": Z, "feas": feas}


def solve_cidgik(
    comp: CidgikCompiled,
    T_goal,
    params: CidgikParams = CidgikParams(),
    dtype=None,
    engine: str = "split",
):
    """Batched CIDGIK solve (solve_with_cidgik, convex_iteration.py:279-319).

    T_goal: (..., 4, 4) or (..., n_ee, 4, 4); leading dims batch.
    Returns dict: q, points (all problem nodes), status, eig_sum, feas,
    T_base. For anchored problems T_base is the identity; under floor_mode
    it is the solved rigid base pose on the floor plane (the gauge freed by
    the planar constraints) and q is extracted in that base frame via
    realign_floor_solution, so the world end-effector pose of q is
    T_base @ fk(q).

    engine: "split" (default) runs the static/dynamic split batched ADMM -
    shared-weight matmuls, host-precomputed static Gram factor, tiny
    per-instance Schur complement. "vmap" is the original per-instance
    engine (oracle path).
    """
    ps = comp.structure
    pos_all = ps.goal_positions(T_goal, dtype=dtype)  # (..., N, dim)
    dt = pos_all.dtype
    d = comp.d
    s = comp.s

    anchors_pos = pos_all[..., jnp.asarray(comp.anchor_idx), :]

    if engine == "split":
        return _solve_cidgik_split(
            comp, T_goal, pos_all, anchors_pos, params
        )

    def single(anc_pos, pos_nodes):
        A_eq, b_eq, A_in, lo, hi = _constraint_matrices(comp, anc_pos, dt)

        Z = jnp.zeros((s, s), dtype=dt).at[:d, :d].set(jnp.eye(d, dtype=dt))
        t = jnp.clip(jnp.zeros(A_in.shape[0], dtype=dt), lo, hi)
        U = (jnp.zeros((s, s), dtype=dt), jnp.zeros(A_in.shape[0], dtype=dt))
        C = jnp.eye(s, dtype=dt)  # identity init (convex_iteration.py:215)

        def outer(carry, _):
            Z, t, U, C, last_cost, done, feas_prev, eig_prev = carry
            Z_new, t_new, U_new, feas = _solve_sdp_admm(
                A_eq, b_eq, A_in, lo, hi, C, Z, t, U, params
            )
            C_new, eig_sum = _fantope(Z_new, d, params.eigh_sweeps)
            cost = jnp.sum(C * Z_new)
            change = jnp.abs(last_cost - cost)
            rel = change / jnp.maximum(jnp.abs(last_cost), 1e-30)
            new_done = done | (
                (change <= params.abs_tol)
                | (cost <= params.abs_tol)
                | (rel < params.rel_tol)
            )
            # frozen lanes keep state
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

        X = Z[d:, :d]  # free point positions (global frame; anchors fix gauge)
        points = pos_nodes
        points = points.at[jnp.asarray(comp.free_idx), :].set(X)
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


def _solve_cidgik_split(comp, T_goal, pos_all, anchors_pos, params):
    """Convex-iteration driver over the split batched ADMM engine."""
    ps = comp.structure
    d = comp.d
    s = comp.s
    dt = pos_all.dtype
    batch = pos_all.shape[:-2]
    B = int(np.prod(batch)) if batch else 1
    anc = anchors_pos.reshape(B, len(comp.anchor_idx), d)
    op = _build_split_operator(comp)
    aux = _split_aux(op, anc, params, dt)
    m_in = op.m_in_s + op.m_in_d

    eye_d = jnp.eye(d, dtype=dt)
    Z0 = jnp.zeros((B, s, s), dt).at[:, :d, :d].set(eye_d)
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
    U0 = (jnp.zeros((B, s, s), dt), jnp.zeros((B, m_in), dt))
    C0 = jnp.broadcast_to(jnp.eye(s, dtype=dt), (B, s, s))

    def keep(done, old, new):
        mask = done.reshape(done.shape + (1,) * (old.ndim - 1))
        return jnp.where(mask, old, new)

    def make_outer(round_params):
        def outer(carry, _):
            Z, t, U, C, last_cost, done, feas_prev, eig_prev = carry
            Z_new, t_new, U_new, feas = _solve_sdp_admm_split(
                op, aux, C, Z, t, U, round_params, d
            )
            C_new, eig_sum = _fantope(Z_new, d, params.eigh_sweeps)
            cost = jnp.sum(C * Z_new, axis=(-2, -1))
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

        X = Z[:, d:, :d]  # (B, n_free, d)
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
