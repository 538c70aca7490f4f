"""Problem-graph compiler: robot template -> static distance-geometry arrays.

The reference builds an `nx.DiGraph` per problem
(/root/reference/graphik/graphs/graph_base.py, graph_revolute.py,
graph_planar.py). Here the graph is *compiled once, host-side* into a
`ProblemStructure` of dense masked matrices; per-goal instance data is then
assembled inside jit, batched over goals.

Node indexing (3D revolute, n joints, n_obs obstacles):
    0..n        -> p0..pn           (main joint points)
    n+1..2n+1   -> q0..qn           (auxiliary rotation-axis points)
    2n+2, 2n+3  -> x, y             (base frame points)
    2n+4..      -> obstacles
Planar (2D): 0..n -> p0..pn, n+1 -> x, n+2 -> y, n+3.. -> obstacles.

Known reference discrepancy, implemented as *intended* here:
`add_spherical_obstacle` (graph_base.py:201-211) and `check_distance_limits`
(graph_base.py:219-260) compare node-TYPE lists against the string ROBOT,
which never matches, silently disabling obstacle bound-edges and post-solve
validation in the reference as shipped. We implement the documented intent:
obstacles add lower-bounded edges to all main robot points p1..pn, and
validation checks every BELOW/ABOVE bounded edge.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from graphik_tpu.robots.templates import RobotTemplate, _se3, _rotz
from graphik_tpu.robots import kinematics
from graphik_tpu.utils import dgp, lie

# Upper "distance" placed on obstacle avoidance edges (graph_base.py:211).
OBSTACLE_UPPER = 100.0

# Bounded-edge classification codes.
UNBOUNDED = 0
BELOW = 1
ABOVE = 2


def _max_min_distance_revolute(r, P, C, N):
    """Host-side circle min/max distance (geometry.py:45-58)."""
    delta = P - C
    axial = float(np.dot(N, delta))
    radial = float(np.linalg.norm(np.cross(N, delta)))
    d_min = np.sqrt(max(axial**2 + (radial - r) ** 2, 0.0))
    d_max = np.sqrt(max(axial**2 + (radial + r) ** 2, 0.0))
    return d_max, d_min


@dataclasses.dataclass(eq=False)  # identity hash: usable as a jit static arg
class ProblemStructure:
    """Static arrays describing one robot + environment template.

    All matrices are (N, N) numpy float64, symmetric. Squared distances in
    ``D_struct``/``psi_*``; unsquared bounds in ``L_edges``/``U_edges``/
    ``check_*``.
    """

    template: RobotTemplate
    axis_length: float
    names: List[str]

    # masks / matrices
    omega_struct: np.ndarray  # bool: edges with exact known distance
    D_struct: np.ndarray  # squared distances on omega_struct
    psi_L: np.ndarray  # squared lower bounds (BELOW edges)
    psi_U: np.ndarray  # squared upper bounds (ABOVE edges)
    edge_mask: np.ndarray  # bool: any edge with bounds (for smoothing)
    L_edges: np.ndarray  # unsquared lower bounds on edge_mask
    U_edges: np.ndarray  # unsquared upper bounds on edge_mask
    bounded_mask: np.ndarray  # bool: BELOW/ABOVE edges (validated)
    check_L: np.ndarray  # unsquared, for check_distance_limits
    check_U: np.ndarray

    # positions
    pos_mask: np.ndarray  # (N,) statically positioned nodes
    pos_fixed: np.ndarray  # (N, dim)
    anchor_mask: np.ndarray  # (N,) positioned incl. goal anchors

    # index maps
    idx_x: int
    idx_y: int
    n_obstacles: int
    obstacles: List[Tuple[np.ndarray, float]]
    limited_joints: List[int]

    # ------------------------------------------------------------------
    # index helpers
    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.template.dim

    @property
    def n(self) -> int:
        return self.template.n

    @property
    def N(self) -> int:
        return len(self.names)

    def idx_p(self, i: int) -> int:
        return i

    def idx_q(self, i: int) -> int:
        assert self.dim == 3
        return self.template.n + 1 + i

    def idx_obs(self, k: int) -> int:
        base = (2 * self.n + 4) if self.dim == 3 else (self.n + 3)
        return base + k

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_template(
        cls,
        template: RobotTemplate,
        axis_length: float = 1.0,
        obstacles: Optional[Sequence[Tuple[np.ndarray, float]]] = None,
    ) -> "ProblemStructure":
        if template.dim == 3:
            ps = _build_revolute(template, axis_length)
        else:
            ps = _build_planar(template)
        for k, (center, radius) in enumerate(obstacles or []):
            ps = ps.add_spherical_obstacle(np.asarray(center, dtype=float), float(radius))
        return ps

    def add_spherical_obstacle(self, center: np.ndarray, radius: float) -> "ProblemStructure":
        """Append an obstacle node (graph_base.py:201-211, intended semantics)."""
        N_old = self.N
        N = N_old + 1
        dim = self.dim

        def grow(M, fill=0.0):
            out = np.full((N, N), fill, dtype=M.dtype)
            out[:N_old, :N_old] = M
            return out

        omega = grow(self.omega_struct)
        D = grow(self.D_struct)
        psi_L = grow(self.psi_L)
        psi_U = grow(self.psi_U)
        edge_mask = grow(self.edge_mask)
        L = grow(self.L_edges)
        U = grow(self.U_edges)
        bounded = grow(self.bounded_mask)
        cL = grow(self.check_L)
        cU = grow(self.check_U)

        pos_mask = np.concatenate([self.pos_mask, [True]])
        pos_fixed = np.vstack([self.pos_fixed, center[None, :dim]])
        anchor_mask = np.concatenate([self.anchor_mask, [True]])
        o = N_old

        def sym(M, i, j, v):
            M[i, j] = v
            M[j, i] = v

        # Anchor edges: exact distance to every statically positioned node
        # (add_anchor_node, graph_base.py:182-199).
        for j in range(N_old):
            if pos_mask[j]:
                d = float(np.linalg.norm(pos_fixed[j] - center[:dim]))
                sym(omega, o, j, True)
                sym(D, o, j, d**2)
                sym(edge_mask, o, j, True)
                sym(L, o, j, d)
                sym(U, o, j, d)

        # Bounded-below edges to main robot points p1..pn (intended
        # semantics of graph_base.py:206-211; p0 is base-typed and fixed).
        for i in range(1, self.n + 1):
            p = self.idx_p(i)
            sym(bounded, o, p, True)
            sym(cL, o, p, radius)
            sym(cU, o, p, OBSTACLE_UPPER)
            sym(psi_L, o, p, radius**2)
            sym(edge_mask, o, p, True)
            sym(L, o, p, radius)
            sym(U, o, p, OBSTACLE_UPPER)

        return dataclasses.replace(
            self,
            names=self.names + [f"o{self.n_obstacles}"],
            omega_struct=omega,
            D_struct=D,
            psi_L=psi_L,
            psi_U=psi_U,
            edge_mask=edge_mask,
            L_edges=L,
            U_edges=U,
            bounded_mask=bounded,
            check_L=cL,
            check_U=cU,
            pos_mask=pos_mask,
            pos_fixed=pos_fixed,
            anchor_mask=anchor_mask,
            n_obstacles=self.n_obstacles + 1,
            obstacles=self.obstacles + [(center, radius)],
        )

    def clear_obstacles(self) -> "ProblemStructure":
        """Rebuild without obstacle nodes (graph_base.py:213-217)."""
        return ProblemStructure.from_template(self.template, self.axis_length)

    def reduced_spec(self) -> Optional[dict]:
        """Anchored-obstacle reduction for the solver hot path.

        The reference keeps obstacles as graph NODES pinned by exact-distance
        edges to every positioned node (graph_base.py:182-211), so the
        optimizer re-derives 100 known positions per solve. Batched design:
        obstacle positions are compile-time constants, so each obstacle
        bound-edge becomes an *anchored hinge term* against a constant point
        and the variable set shrinks back to the robot subgraph
        (N - n_obstacles nodes). For a table scene this cuts the edge count
        ~50x and the variable count 7x with identical feasibility semantics
        (validation still runs on the full graph).

        Returns None when there are no obstacles, else a dict:
          Nr       variable node count (robot + base + aux)
          idx      (A,) int32 robot-node row per anchored term
          centers  (A, dim) constant anchor points
          psi_L, psi_U, L_mask, U_mask  (A,) squared hinge bounds/masks
        """
        if self.n_obstacles == 0:
            return None
        Nr = self.N - self.n_obstacles
        rows, cols = [], []
        for k in range(self.n_obstacles):
            o = Nr + k
            for i in range(Nr):
                if self.bounded_mask[i, o]:
                    rows.append(i)
                    cols.append(o)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        psi_L = self.psi_L[rows, cols]
        psi_U = self.psi_U[rows, cols]
        diff = psi_L != psi_U
        return {
            "Nr": Nr,
            "idx": rows.astype(np.int32),
            "centers": np.asarray(self.pos_fixed[cols], np.float64),
            "psi_L": np.asarray(psi_L, np.float64),
            "psi_U": np.asarray(psi_U, np.float64),
            "L_mask": (diff & (psi_L > 0)).astype(np.float64),
            "U_mask": (diff & (psi_U > 0)).astype(np.float64),
        }

    def distance_bounds_from_sampling(
        self, key=None, n_samples: int = 2000
    ) -> "ProblemStructure":
        """Empirical all-pairs distance bounds from random configurations.

        Batched equivalent of graph_revolute.py:329-350: sample n_samples
        random configurations, take elementwise min/max distances, install
        them as [LOWER, UPPER] on every node pair; pairs with max-min < 1e-5
        become exact edges. Returns an updated copy.
        """
        if key is None:
            key = jax.random.PRNGKey(0)
        q = kinematics.random_configuration(self.template, key, (n_samples,))
        pos = self.realization(q)  # (S, N, dim)
        D = jnp.sqrt(jnp.maximum(dgp.distance_matrix_from_pos(pos), 0.0))
        D_min = np.asarray(jnp.min(D, axis=0))
        D_max = np.asarray(jnp.max(D, axis=0))

        L = D_min.copy()
        U = D_max.copy()
        edge_mask = np.ones_like(self.edge_mask, dtype=bool)
        np.fill_diagonal(edge_mask, False)
        near_exact = (D_max - D_min) < 1e-5
        omega = self.omega_struct | (near_exact & edge_mask)
        D_struct = self.D_struct.copy()
        new_exact = near_exact & edge_mask & ~self.omega_struct
        D_struct[new_exact] = (0.5 * (D_min + D_max))[new_exact] ** 2

        return dataclasses.replace(
            self,
            omega_struct=omega,
            D_struct=D_struct,
            L_edges=L,
            U_edges=U,
            edge_mask=edge_mask,
        )

    # ------------------------------------------------------------------
    # device-side: instance assembly
    # ------------------------------------------------------------------
    def goal_positions(self, T_goal, dtype=None):
        """Node positions implied by end-effector goal pose(s).

        T_goal: (..., hd, hd) single-ee or (..., n_ee, hd, hd).
        Returns (..., N, dim) positions (zeros at unpositioned nodes) -
        fixed nodes + goal anchors (graph_revolute.py:243-249 /
        graph_planar.py:136-145).
        """
        tpl = self.template
        T_goal = jnp.asarray(T_goal, dtype=dtype)
        n_ee = len(tpl.ee)
        if T_goal.shape[-3:-2] != (n_ee,) or T_goal.ndim < 3:
            T_goal = T_goal[..., None, :, :]  # single-ee convenience
        batch = T_goal.shape[:-3]
        pos = jnp.broadcast_to(
            jnp.asarray(self.pos_fixed, dtype=T_goal.dtype), batch + (self.N, self.dim)
        )
        dim = self.dim
        for e, ee in enumerate(tpl.ee):
            Te = T_goal[..., e, :, :]
            t = Te[..., :dim, dim]
            if dim == 3:
                qt = t + self.axis_length * Te[..., :3, 2]
                pos = pos.at[..., self.idx_p(int(ee)), :].set(t)
                pos = pos.at[..., self.idx_q(int(ee)), :].set(qt)
            else:
                # anchor ee and its predecessor along the goal x-axis
                pred = int(tpl.parents[int(ee)])
                d = float(tpl.link_lengths[int(ee)])
                z = Te[..., :2, 0]
                pos = pos.at[..., self.idx_p(int(ee)), :].set(t)
                pos = pos.at[..., self.idx_p(pred), :].set(t - z * d)
        return pos

    @partial(jax.jit, static_argnums=0,
             static_argnames=("dtype", "smooth", "n_nodes", "smooth_iters"))
    def instance(self, T_goal, dtype=None, smooth=True, n_nodes=None,
                 smooth_iters=None):
        """Assemble per-goal solver inputs (batched, jittable).

        Returns dict with:
          D_goal: (..., M, M) squared goal distance matrix
          pos_anchor: (..., M, dim) anchor positions
          lb, ub: (..., M, M) smoothed unsquared bounds (if smooth)
        where M = n_nodes or N. `omega`, `psi_L`, `psi_U` are static - see
        `masks()`.

        n_nodes: restrict assembly to the first n_nodes nodes - used with
        the anchored-obstacle reduction (reduced_spec), where the heavy
        prepare stages (min-plus bound smoothing on the 2M x 2M doubled
        graph, batched MDS eigh) would otherwise scale cubically with the
        obstacle count for nodes the solver never optimizes. Obstacle
        bound edges are folded into the reduced smoothing in closed form
        (dgp.bound_smoothing_anchored) - the reduced bounds equal the
        full-graph bounds on the reduced block at O(M^2 n_obs) extra cost
        instead of O((M + n_obs)^3).
        """
        M = self.N if n_nodes is None else int(n_nodes)
        pos = self.goal_positions(T_goal, dtype=dtype)[..., :M, :]
        dt = pos.dtype
        anchor = jnp.asarray(self.anchor_mask[:M])
        pair = anchor[:, None] & anchor[None, :] & ~jnp.eye(M, dtype=bool)

        D_anchor = dgp.distance_matrix_from_pos(pos)
        D_goal = jnp.where(
            pair, D_anchor, jnp.asarray(self.D_struct[:M, :M], dtype=dt))

        out = {"D_goal": D_goal, "pos_anchor": pos}
        if smooth:
            d_anchor = jnp.sqrt(jnp.maximum(D_anchor, 0.0))
            L = jnp.where(
                pair, d_anchor, jnp.asarray(self.L_edges[:M, :M], dtype=dt))
            U = jnp.where(
                pair, d_anchor, jnp.asarray(self.U_edges[:M, :M], dtype=dt))
            mask = jnp.asarray(self.edge_mask[:M, :M]) | pair
            if M < self.N:
                # Anchored-obstacle fold: the excluded nodes sit at known
                # positions, so their bound edges enter the reduced
                # smoothing as closed-form side-node terms.
                obs_pos = np.asarray(self.pos_fixed[M:], np.float64)
                d_ro = jnp.sqrt(jnp.maximum(jnp.sum(
                    (pos[..., :, None, :]
                     - jnp.asarray(obs_pos, dtype=dt)[None, :, :]) ** 2,
                    axis=-1,
                ), 0.0))  # (..., M, no)
                anch = jnp.asarray(self.anchor_mask[:M])[:, None]
                ro_mask = jnp.asarray(self.edge_mask[:M, M:])
                U_ro_edges = jnp.asarray(self.U_edges[:M, M:], dtype=dt)
                L_ro_edges = jnp.asarray(self.L_edges[:M, M:], dtype=dt)
                U_ro = jnp.minimum(
                    jnp.where(anch, d_ro, dgp.BIG),
                    jnp.where(ro_mask, U_ro_edges, dgp.BIG),
                )
                L_ro = jnp.maximum(
                    jnp.where(anch, d_ro, 0.0),
                    jnp.where(ro_mask, L_ro_edges, 0.0),
                )
                D_oo = np.sqrt(np.maximum(np.sum(
                    (obs_pos[:, None, :] - obs_pos[None, :, :]) ** 2, axis=-1
                ), 0.0))
                lb, ub = dgp.bound_smoothing_anchored(
                    L, U, mask, U_ro, L_ro, D_oo, n_iter=smooth_iters
                )
            else:
                lb, ub = dgp.bound_smoothing(L, U, mask,
                                             n_iter=smooth_iters)
            out["lb"], out["ub"] = lb, ub
        return out

    def masks(self):
        """Static solver masks: (omega, psi_L, psi_U) as numpy arrays.

        omega includes the anchor-pair completion edges (graph_complete_edges,
        dgp.py:124-147): distances among positioned nodes are exact.
        """
        anchor = self.anchor_mask
        pair = np.logical_and.outer(anchor, anchor) & ~np.eye(self.N, dtype=bool)
        omega = self.omega_struct | pair
        return omega, self.psi_L, self.psi_U

    # ------------------------------------------------------------------
    # device-side: realization / validation / joint extraction
    # ------------------------------------------------------------------
    @partial(jax.jit, static_argnums=0)
    def realization(self, q):
        """(..., n) joint angles -> (..., N, dim) node positions.

        Batched equivalent of graph_base.py:112-120 (FK into point graph).
        """
        tpl = self.template
        q = jnp.asarray(q)
        p_pos, q_pos = kinematics.joint_positions(tpl, q, self.axis_length)
        batch = q.shape[:-1]
        pos = jnp.broadcast_to(
            jnp.asarray(self.pos_fixed, dtype=q.dtype), batch + (self.N, self.dim)
        )
        pos = pos.at[..., 0 : tpl.n + 1, :].set(p_pos)
        if self.dim == 3:
            pos = pos.at[..., tpl.n + 1 : 2 * tpl.n + 2, :].set(q_pos)
        return pos

    @partial(jax.jit, static_argnums=0, static_argnames=("tol",))
    def check_distance_limits(self, pos, tol=1e-6):
        """Max violation of BELOW/ABOVE bounded edges at positions `pos`.

        Batched equivalent of graph_base.py:219-260 (intended semantics).
        Returns (max_violation, ok) where ok = max_violation <= 0 at `tol`.
        """
        pos = jnp.asarray(pos)
        D = jnp.sqrt(jnp.maximum(dgp.distance_matrix_from_pos(pos), 0.0))
        bounded = jnp.asarray(self.bounded_mask)
        cL = jnp.asarray(self.check_L, dtype=pos.dtype)
        cU = jnp.asarray(self.check_U, dtype=pos.dtype)
        below = jnp.where(bounded, (cL - tol) - D, -jnp.inf)
        above = jnp.where(bounded, D - (cU + tol), -jnp.inf)
        viol = jnp.maximum(below, above)
        max_viol = jnp.max(viol, axis=(-2, -1))
        return max_viol, max_viol <= 0.0

    @partial(jax.jit, static_argnums=0)
    def joint_variables(self, pos, T_goal=None):
        """Recover joint angles from solved node positions.

        Batched equivalent of graph_revolute.py:251-318 /
        graph_planar.py:147-176. `pos` is (..., N, dim); `T_goal` optionally
        supplies end-effector poses for the final-joint correction when the
        last relative translation is along z (graph_revolute.py:313-316).

        HIGHEST matmul precision regardless of caller scope: the per-joint
        frame accumulation is a matmul chain that, with float32 matmuls in
        TF32, injects ~1e-3 relative angle noise.
        """
        with jax.default_matmul_precision("highest"):
            if self.dim == 3:
                return _joint_variables_revolute(self, pos, T_goal)
            return _joint_variables_planar(self, pos)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------

def _sym_set(M, i, j, v):
    M[i, j] = v
    M[j, i] = v


def _build_revolute(tpl: RobotTemplate, axis_length: float) -> ProblemStructure:
    """Base + structure + limit edges for a 3D revolute robot.

    Mirrors ProblemGraphRevolute.__init__ (graph_revolute.py:15-30):
    base_subgraph, structure_graph, set_limits, root_angle_limits.
    """
    n = tpl.n
    N = 2 * (n + 1) + 2
    idx_p = lambda i: i
    idx_q = lambda i: n + 1 + i
    idx_x, idx_y = 2 * n + 2, 2 * n + 3
    names = (
        [f"p{i}" for i in range(n + 1)]
        + [f"q{i}" for i in range(n + 1)]
        + ["x", "y"]
    )

    omega = np.zeros((N, N), dtype=bool)
    D = np.zeros((N, N))
    psi_L = np.zeros((N, N))
    psi_U = np.zeros((N, N))
    edge_mask = np.zeros((N, N), dtype=bool)
    L = np.zeros((N, N))
    U = np.zeros((N, N))
    bounded = np.zeros((N, N), dtype=bool)
    cL = np.zeros((N, N))
    cU = np.zeros((N, N))

    T_axis = _se3(np.eye(3), [0, 0, axis_length])
    T0 = tpl.T0  # (n+1, 4, 4)
    p_pos = T0[:, :3, 3]
    q_pos = np.einsum("nij,j->ni", T0 @ T_axis, np.array([0.0, 0.0, 0.0, 1.0]))[:, :3]

    def add_exact(i, j, d):
        _sym_set(omega, i, j, True)
        _sym_set(D, i, j, d**2)
        _sym_set(edge_mask, i, j, True)
        _sym_set(L, i, j, d)
        _sym_set(U, i, j, d)

    # --- base subgraph (graph_revolute.py:32-57) ---
    base_pos = {
        idx_p(0): np.zeros(3),
        idx_x: np.array([axis_length, 0.0, 0.0]),
        idx_y: np.array([0.0, -axis_length, 0.0]),
        idx_q(0): np.array([0.0, 0.0, axis_length]),
    }
    base_edges = [
        (idx_p(0), idx_x),
        (idx_p(0), idx_y),
        (idx_p(0), idx_q(0)),
        (idx_x, idx_y),
        (idx_y, idx_q(0)),
        (idx_q(0), idx_x),
    ]
    for i, j in base_edges:
        add_exact(i, j, float(np.linalg.norm(base_pos[i] - base_pos[j])))

    # --- structure subgraph (graph_revolute.py:59-106) ---
    for path in tpl.paths:
        path = [int(v) for v in path if v >= 0]
        for k, cur in enumerate(path):
            add_exact(
                idx_p(cur), idx_q(cur), float(np.linalg.norm(p_pos[cur] - q_pos[cur]))
            )
            if k > 0:
                prev = path[k - 1]
                pts = {
                    idx_p(prev): p_pos[prev],
                    idx_q(prev): q_pos[prev],
                    idx_p(cur): p_pos[cur],
                    idx_q(cur): q_pos[cur],
                }
                for u in (idx_p(prev), idx_q(prev)):
                    for v in (idx_p(cur), idx_q(cur)):
                        add_exact(u, v, float(np.linalg.norm(pts[u] - pts[v])))

    limited_joints: List[int] = []

    def limit_edge(u_idx, v_idx, T0m, T1m, T2m, P, cur_node):
        """Shared circle-geometry limit logic (graph_revolute.py:190-239)."""
        Nax = T1m[:3, 2]
        C = T1m[:3, 3] + np.dot(Nax, T2m[:3, 3] - T1m[:3, 3]) * Nax
        r = float(np.linalg.norm(T2m[:3, 3] - C))
        d_max, d_min = _max_min_distance_revolute(r, P, C, Nax)
        d = float(np.linalg.norm(T2m[:3, 3] - P))

        # classification mirrors the reference's exact float comparisons
        if np.isclose(d_max, d_min, rtol=1e-12, atol=1e-12):
            limit = UNBOUNDED  # exact
            exact = True
        elif np.isclose(d, d_max, rtol=1e-12, atol=1e-12):
            limit, exact = BELOW, False
        elif np.isclose(d, d_min, rtol=1e-12, atol=1e-12):
            limit, exact = ABOVE, False
        else:
            limit, exact = UNBOUNDED, False

        if limit != UNBOUNDED:
            rot_limit = _se3(_rotz(tpl.ub[cur_node]), np.zeros(3))
            T_rel = np.linalg.inv(T1m) @ T2m
            d_limit = float(np.linalg.norm((T1m @ rot_limit @ T_rel)[:3, 3] - P))
            if limit == ABOVE:
                d_max = d_limit
            else:
                d_min = d_limit
            limited_joints.append(cur_node)

        if exact:
            _sym_set(omega, u_idx, v_idx, True)
            _sym_set(D, u_idx, v_idx, d_max**2)
        _sym_set(edge_mask, u_idx, v_idx, True)
        _sym_set(L, u_idx, v_idx, d_min)
        _sym_set(U, u_idx, v_idx, d_max)
        if limit in (BELOW, ABOVE):
            _sym_set(bounded, u_idx, v_idx, True)
            _sym_set(cL, u_idx, v_idx, d_min)
            _sym_set(cU, u_idx, v_idx, d_max)
            if limit == BELOW:
                _sym_set(psi_L, u_idx, v_idx, d_min**2)
            else:
                _sym_set(psi_U, u_idx, v_idx, d_max**2)

    # --- set_limits: 2-apart pairs (graph_revolute.py:167-241) ---
    for path in tpl.paths:
        path = [int(v) for v in path if v >= 0]
        for k in range(2, len(path)):
            prev, mid, cur = path[k - 2], path[k - 1], path[k]
            for use_aux0 in (False, True):
                for use_aux2 in (False, True):
                    T0m = T0[prev] @ (T_axis if use_aux0 else np.eye(4))
                    T1m = T0[mid]
                    T2m = T0[cur] @ (T_axis if use_aux2 else np.eye(4))
                    u_idx = idx_q(prev) if use_aux0 else idx_p(prev)
                    v_idx = idx_q(cur) if use_aux2 else idx_p(cur)
                    limit_edge(u_idx, v_idx, T0m, T1m, T2m, T0m[:3, 3], cur)

    # --- root_angle_limits: x,y vs p1,q1 (graph_revolute.py:108-165) ---
    if n >= 1:
        first = int(tpl.paths[0][1]) if tpl.paths.shape[1] > 1 else None
        # every ee path shares the same first joint only for chains; handle
        # each path's first node (reference hard-codes "p1")
        firsts = sorted({int(p[1]) for p in tpl.paths if len(p) > 1 and p[1] >= 0})
        for first in firsts:
            T1m = T0[0]
            for base_idx in (idx_x, idx_y):
                for use_aux in (False, True):
                    T2m = T0[first] @ (T_axis if use_aux else np.eye(4))
                    v_idx = idx_q(first) if use_aux else idx_p(first)
                    P = base_pos[base_idx]
                    limit_edge(base_idx, v_idx, None, T1m, T2m, P, first)

    pos_mask = np.zeros(N, dtype=bool)
    pos_fixed = np.zeros((N, 3))
    for i, p in base_pos.items():
        pos_mask[i] = True
        pos_fixed[i] = p

    anchor_mask = pos_mask.copy()
    for ee in tpl.ee:
        anchor_mask[idx_p(int(ee))] = True
        anchor_mask[idx_q(int(ee))] = True

    return ProblemStructure(
        template=tpl,
        axis_length=axis_length,
        names=names,
        omega_struct=omega,
        D_struct=D,
        psi_L=psi_L,
        psi_U=psi_U,
        edge_mask=edge_mask,
        L_edges=L,
        U_edges=U,
        bounded_mask=bounded,
        check_L=cL,
        check_U=cU,
        pos_mask=pos_mask,
        pos_fixed=pos_fixed,
        anchor_mask=anchor_mask,
        idx_x=idx_x,
        idx_y=idx_y,
        n_obstacles=0,
        obstacles=[],
        limited_joints=sorted(set(limited_joints)),
    )


def _build_planar(tpl: RobotTemplate) -> ProblemStructure:
    """Base + structure + limit edges for a 2D robot (graph_planar.py)."""
    n = tpl.n
    N = n + 3
    idx_x, idx_y = n + 1, n + 2
    names = [f"p{i}" for i in range(n + 1)] + ["x", "y"]

    omega = np.zeros((N, N), dtype=bool)
    D = np.zeros((N, N))
    psi_L = np.zeros((N, N))
    psi_U = np.zeros((N, N))
    edge_mask = np.zeros((N, N), dtype=bool)
    L = np.zeros((N, N))
    U = np.zeros((N, N))
    bounded = np.zeros((N, N), dtype=bool)
    cL = np.zeros((N, N))
    cU = np.zeros((N, N))

    p_pos = tpl.T0[:, :2, 2]

    def add_exact(i, j, d):
        _sym_set(omega, i, j, True)
        _sym_set(D, i, j, d**2)
        _sym_set(edge_mask, i, j, True)
        _sym_set(L, i, j, d)
        _sym_set(U, i, j, d)

    # base: p0=(0,0), x=(-1,0), y=(0,1) (graph_planar.py:30-48)
    base_pos = {0: np.zeros(2), idx_x: np.array([-1.0, 0.0]), idx_y: np.array([0.0, 1.0])}
    for i, j in [(0, idx_x), (0, idx_y), (idx_x, idx_y)]:
        add_exact(i, j, float(np.linalg.norm(base_pos[i] - base_pos[j])))

    # structure: consecutive p edges (graph_planar.py:50-88)
    for i in range(1, n + 1):
        par = int(tpl.parents[i])
        add_exact(par, i, float(np.linalg.norm(p_pos[i] - p_pos[par])))

    def law_of_cos(l1, l2, lim):
        return float(np.sqrt(max(l1**2 + l2**2 - 2 * l1 * l2 * np.cos(np.pi - lim), 0.0)))

    def add_below(i, j, lo, hi):
        _sym_set(edge_mask, i, j, True)
        _sym_set(L, i, j, lo)
        _sym_set(U, i, j, hi)
        _sym_set(bounded, i, j, True)
        _sym_set(cL, i, j, lo)
        _sym_set(cU, i, j, hi)
        _sym_set(psi_L, i, j, lo**2)

    # set_limits: 2-apart pairs (graph_planar.py:110-134)
    children = [[] for _ in range(n + 1)]
    for i in range(1, n + 1):
        children[int(tpl.parents[i])].append(i)
    for u in range(n + 1):
        for v1 in children[u]:
            for v2 in children[v1]:
                l1 = float(tpl.link_lengths[v1])
                l2 = float(tpl.link_lengths[v2])
                lim = max(abs(tpl.ub[v2]), abs(tpl.lb[v2]))
                add_below(u, v2, law_of_cos(l1, l2, lim), l1 + l2)

    # root_angle_limits: x vs children of p0 (graph_planar.py:90-108)
    l1 = float(np.linalg.norm(base_pos[idx_x]))
    for v in children[0]:
        l2 = float(tpl.link_lengths[v])
        lim = max(abs(tpl.ub[v]), abs(tpl.lb[v]))
        add_below(idx_x, v, law_of_cos(l1, l2, lim), l1 + l2)

    pos_mask = np.zeros(N, dtype=bool)
    pos_fixed = np.zeros((N, 2))
    for i, p in base_pos.items():
        pos_mask[i] = True
        pos_fixed[i] = p

    anchor_mask = pos_mask.copy()
    for ee in tpl.ee:
        anchor_mask[int(ee)] = True
        anchor_mask[int(tpl.parents[int(ee)])] = True

    return ProblemStructure(
        template=tpl,
        axis_length=1.0,
        names=names,
        omega_struct=omega,
        D_struct=D,
        psi_L=psi_L,
        psi_U=psi_U,
        edge_mask=edge_mask,
        L_edges=L,
        U_edges=U,
        bounded_mask=bounded,
        check_L=cL,
        check_U=cU,
        pos_mask=pos_mask,
        pos_fixed=pos_fixed,
        anchor_mask=anchor_mask,
        idx_x=idx_x,
        idx_y=idx_y,
        n_obstacles=0,
        obstacles=[],
        limited_joints=[],
    )


# ---------------------------------------------------------------------------
# joint-variable extraction
# ---------------------------------------------------------------------------

def _joint_variables_revolute(ps: ProblemStructure, pos, T_goal):
    """Batched revolute joint recovery (graph_revolute.py:251-318)."""
    tpl = ps.template
    pos = jnp.asarray(pos)
    dt = pos.dtype
    n = tpl.n
    al = ps.axis_length

    def single(P, Tg):
        # gauge fix from base points (graph_revolute.py:269-279)
        p0 = P[ps.idx_p(0)]
        x_hat = P[ps.idx_x] - p0
        y_hat = P[ps.idx_y] - p0
        z_hat = P[ps.idx_q(0)] - p0
        nrm = lambda v: v / jnp.linalg.norm(v)
        R = jnp.stack([nrm(x_hat), -nrm(y_hat), nrm(z_hat)], axis=-1)
        B = lie.se3_make(R, p0)
        B_inv = lie.se3_inv(B)

        T0 = jnp.asarray(tpl.T0, dtype=dt)
        T_axis = lie.se3_trans_axis(jnp.asarray(al, dtype=dt))

        theta = jnp.zeros(n + 1, dtype=dt)
        T_prev_all = jnp.zeros((n + 1, 4, 4), dtype=dt).at[0].set(T0[0])

        def body(carry, k):
            theta, T_all = carry
            cur = k
            pred = jnp.asarray(tpl.parents)[k]
            T_prev = T_all[pred]

            T_prev_0 = T0[pred]
            T_0 = T0[cur]
            T_0_q = T_0 @ T_axis
            T_rel = lie.se3_inv(T_prev_0) @ T_0
            qs_0 = (lie.se3_inv(T_prev_0) @ T_0_q)[:3, 3]

            p_pt = P[cur]
            q_pt_raw = P[n + 1 + cur]
            diff = q_pt_raw - p_pt
            qnorm = p_pt + diff / jnp.linalg.norm(diff)
            p_in_B = (B_inv[:3, :3] @ p_pt) + B_inv[:3, 3]
            q_in_B = (B_inv[:3, :3] @ qnorm) + B_inv[:3, 3]
            R_prev_T = T_prev[:3, :3].T
            qs = R_prev_T @ (q_in_B - T_prev[:3, 3])

            # theta = atan2(-qs0^T Omega_z qs, qs0^T Omega_z Omega_z^T qs)
            # with Omega_z = skew(z) (graph_revolute.py:281-308)
            num = -(qs_0[0] * (-qs[1]) + qs_0[1] * qs[0])
            den = qs_0[0] * qs[0] + qs_0[1] * qs[1]
            th = jnp.arctan2(num, den)

            T_cur = (T_prev @ lie.se3_rotz(th)) @ T_rel
            theta = theta.at[cur].set(th)
            T_all = T_all.at[cur].set(T_cur)
            return (theta, T_all), None

        (theta, T_all), _ = jax.lax.scan(
            body, (theta, T_prev_all), jnp.arange(1, n + 1)
        )

        # final-joint correction when last axis is along ee z
        # (graph_revolute.py:313-316)
        if Tg is not None:
            for e, ee in enumerate(tpl.ee):
                ee = int(ee)
                pred = int(tpl.parents[ee])
                T_rel_np = np.linalg.inv(tpl.T0[pred]) @ tpl.T0[ee]
                aligned = (
                    np.linalg.norm(np.cross(T_rel_np[:3, 3], [0.0, 0.0, 1.0]))
                    < 1e-10
                )
                if aligned:
                    Te = Tg[e]
                    T_th = lie.se3_inv(T_all[ee]) @ Te
                    delta = jnp.arctan2(T_th[1, 0], T_th[0, 0])
                    theta = theta.at[ee].set(lie.wraptopi(theta[ee] + delta))
        return theta[1:]

    if T_goal is not None:
        Tg = jnp.asarray(T_goal, dtype=dt)
        n_ee = len(tpl.ee)
        if Tg.shape[-3:-2] != (n_ee,) or Tg.ndim < 3:
            Tg = Tg[..., None, :, :]
        fn = single
        for _ in range(pos.ndim - 2):
            fn = jax.vmap(fn)
        return fn(pos, Tg)
    fn = lambda P: single(P, None)
    for _ in range(pos.ndim - 2):
        fn = jax.vmap(fn)
    return fn(pos)


def _joint_variables_planar(ps: ProblemStructure, pos):
    """Batched planar joint recovery (graph_planar.py:147-176)."""
    tpl = ps.template
    pos = jnp.asarray(pos)
    dt = pos.dtype
    n = tpl.n

    canon = jnp.asarray(
        np.array([[0.0, 0.0], [-1.0, 0.0], [0.0, 1.0]]), dtype=dt
    )

    def single(P):
        src = jnp.stack([P[0], P[ps.idx_x], P[ps.idx_y]], axis=0)
        R_, _ = dgp.best_fit_transform(src, canon)

        theta = jnp.zeros(n + 1, dtype=dt)
        R_all = jnp.zeros((n + 1, 2, 2), dtype=dt).at[0].set(jnp.eye(2, dtype=dt))

        def body(carry, k):
            theta, R_acc = carry
            u = jnp.asarray(tpl.parents)[k]
            diff = R_ @ (P[k] - P[u])
            diff = diff / jnp.linalg.norm(diff)
            sol = R_acc[u].T @ diff
            th = lie.wraptopi(jnp.arctan2(sol[1], sol[0]))
            R_new = R_acc[u] @ lie.rot2(th)
            return (theta.at[k].set(th), R_acc.at[k].set(R_new)), None

        (theta, _), _ = jax.lax.scan(body, (theta, R_all), jnp.arange(1, n + 1))
        return theta[1:]

    fn = single
    for _ in range(pos.ndim - 2):
        fn = jax.vmap(fn)
    return fn(pos)
