"""Data-parallel fleet layer: mesh sharding, restart pools, metrics.

The reference is single-threaded, one IK instance at a time (SURVEY.md
section 2.6); scale here is *created* by sharding the instance batch over a
1-D device mesh. Problems are tiny (N ~ 16) and independent, so data
parallelism over goals x restarts is the only meaningful axis; collectives
are reductions at the end (success rates, best-of-restart selection).

Multi-host: call `jax.distributed.initialize()` before building the mesh;
`make_mesh` uses all visible devices. The cards of one host are joined all
to all (NVLink), so the mesh stays 1-D.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphik_tpu import api
from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.solvers import riemannian
from graphik_tpu.solvers.riemannian import TRParams
from graphik_tpu.utils import dgp


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch") -> Mesh:
    """1-D device mesh over the instance batch axis."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def shard_batch(x, mesh: Mesh, axis_name: str = "batch"):
    """Place a batched pytree with its leading axis sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda a: jax.device_put(a, sharding), x)


def solve_ik_sharded(
    structure: ProblemStructure,
    T_goal,
    mesh: Mesh,
    params: TRParams = TRParams(),
    axis_name: str = "batch",
    **kwargs,
):
    """Batched IK solve with the goal batch sharded over the mesh.

    The solve is embarrassingly parallel. shard_map (not sharding-annotated
    jit) pins one per-device kernel invocation per shard: under plain jit
    the SPMD partitioner has no partitioning rule for the fused Pallas
    solver call and may materialize the full batch on every device, which
    silently destroys data-parallel scaling.
    """
    in_sharding = NamedSharding(mesh, P(axis_name))
    fn = _sharded_runner(structure, mesh, params, axis_name, kwargs)
    # shard_map requires the batch axis to divide evenly over the mesh
    # (the previous sharding-annotated jit tolerated ragged shards): pad
    # with copies of goal 0 and slice every output back to the true batch.
    T_goal = jnp.asarray(T_goal)
    B = T_goal.shape[0]
    n_shards = mesh.shape[axis_name]
    Bp = -(-B // n_shards) * n_shards
    if Bp != B:
        pad = jnp.broadcast_to(T_goal[:1], (Bp - B,) + T_goal.shape[1:])
        T_goal = jnp.concatenate([T_goal, pad], axis=0)
    T_goal = jax.device_put(T_goal, in_sharding)
    out = fn(T_goal)
    if Bp != B:
        out = jax.tree.map(lambda a: a[:B], out)
    return out


_SHARDED_RUNNERS: dict = {}


def _sharded_runner(structure, mesh, params, axis_name, kwargs):
    """jit(shard_map(solve_ik)) for these arguments, built once: a fresh
    jit object per call would retrace and recompile every solve."""
    try:
        key = (id(structure), mesh, params, axis_name,
               tuple(sorted(kwargs.items())))
        hash(key)
    except TypeError:
        key = None
    hit = _SHARDED_RUNNERS.get(key) if key is not None else None
    if hit is not None and hit[0] is structure:
        return hit[1]
    local = partial(api.solve_ik, structure, params=params, **kwargs)
    fn = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=P(axis_name), out_specs=P(axis_name),
        check_vma=False,  # while_loop carries + Pallas out_shapes predate
        # the varying-manual-axes checker; classic shard_map semantics.
    ))
    if key is not None:
        _SHARDED_RUNNERS[key] = (structure, fn)
    return fn


def solve_ik_restarts(
    structure: ProblemStructure,
    T_goal,
    key,
    n_restarts: int = 4,
    params: TRParams = TRParams(),
    use_limits: bool = True,
    dtype=None,
    polish: bool = True,
):
    """Multi-restart solve with per-goal best-solution selection.

    Restart 0 uses the reference's deterministic bound-interpolation init
    (riemannian_solver.py:67-75); further restarts sample the distance
    matrix uniformly inside the smoothed bounds (dgp.py:187-189). The best
    restart per goal is chosen by (limit-feasible, pose error).

    Returns the selected per-goal result dict plus "restart_index".
    """
    # float32 matmuls may run in TF32 unless HIGHEST is asked for (same
    # scoping as api.solve_ik).
    with jax.default_matmul_precision("highest"):
        return _solve_ik_restarts_impl(
            structure, T_goal, key, n_restarts, params, use_limits, dtype, polish
        )


def _solve_ik_restarts_impl(
    structure, T_goal, key, n_restarts, params, use_limits, dtype, polish
):
    spec = structure.reduced_spec()
    Nr = spec["Nr"] if spec is not None else None
    inst = structure.instance(T_goal, dtype=dtype, smooth=True, n_nodes=Nr)
    omega_np, psi_L, psi_U = structure.masks()
    dim = structure.dim
    omega = jnp.asarray(omega_np if Nr is None else omega_np[:Nr, :Nr])

    keys = jax.random.split(key, n_restarts)

    def init_for(i, k):
        frac_key = None if i == 0 else k
        return riemannian.generate_initialization(
            inst["lb"], inst["ub"], omega, dim, key=frac_key
        )

    Y0s = jnp.stack([init_for(i, keys[i]) for i in range(n_restarts)])

    # Restarts fold into the instance batch (leading axis R*B) instead of a
    # vmap over the solver: every backend - including the fused Pallas
    # kernel, which manages its own batch tiling - sees one flat batch.
    R = n_restarts
    batch_shape = inst["D_goal"].shape[:-2]

    def fold(x):
        inner = x.shape[len(batch_shape):]
        x = jnp.broadcast_to(x, (R,) + batch_shape + inner)
        return x.reshape((-1,) + inner)

    def unfold(x):
        return x.reshape((R,) + batch_shape + x.shape[1:])

    D_goal_f = fold(inst["D_goal"])
    Y0_f = Y0s.reshape((-1,) + Y0s.shape[1 + len(batch_shape):])
    T_goal_f = fold(jnp.asarray(T_goal, dtype=Y0s.dtype))

    sol = api.solve_reduced(
        structure, Y0_f, D_goal_f, omega_np, psi_L, psi_U,
        params=params, use_limits=use_limits,
    )
    q = structure.joint_variables(sol["Y"], T_goal_f)
    pos_fk = structure.realization(q)
    viol, ok = structure.check_distance_limits(pos_fk)
    e_pos, e_rot = api.pose_error(structure, q, T_goal_f)
    if polish:
        q, e_pos, e_rot, viol, ok = api.polish_solution(
            structure, q, T_goal_f, e_pos, e_rot, viol, ok
        )
    all_out = {
        "q": q,
        "Y": sol["Y"],
        "cost": sol["cost"],
        "gradnorm": sol["gradnorm"],
        "iterations": sol["iterations"],
        "e_pos": e_pos,
        "e_rot": e_rot,
        "limit_violation": viol,
        "success": ok,
    }
    all_out = {k: unfold(v) for k, v in all_out.items()}  # leading axis: restart
    return _select_best_restart(all_out)


def _select_best_restart(all_out):
    """Per-goal selection: feasible first, then pose error (pos + rot)."""
    score = all_out["e_pos"] + all_out["e_rot"] + jnp.where(
        all_out["success"], 0.0, 1e6
    )
    best = jnp.argmin(score, axis=0)  # (..., batch)

    def pick(x):
        return jnp.take_along_axis(
            x, best[None, ...].reshape((1,) + best.shape + (1,) * (x.ndim - 1 - best.ndim)),
            axis=0,
        )[0]

    out = {k: pick(v) for k, v in all_out.items()}
    out["restart_index"] = best
    return out


def make_restart_solver(
    structure: ProblemStructure,
    n_restarts: int = 4,
    params: TRParams = TRParams(),
    use_limits: bool = True,
    dtype=None,
    polish: bool = True,
    polish_params=None,
    smooth_iters=None,
):
    """Stage-jitted multi-restart solver (mirrors api.make_solver).

    The monolithic restart pipeline compiles superlinearly in program size,
    so prepare / solve / finish+select are jitted separately and chained on
    the host. Returns solver(T_goal, key) -> selected per-goal result dict.
    """
    omega_np, psi_L, psi_U = structure.masks()
    dim = structure.dim
    R = n_restarts
    spec = structure.reduced_spec()
    Nr = spec["Nr"] if spec is not None else None
    omega_prep = omega_np if Nr is None else omega_np[:Nr, :Nr]

    @jax.jit
    def stage_prepare(T_goal, key):
        with jax.default_matmul_precision("highest"):
            inst = structure.instance(
                T_goal, dtype=dtype, smooth=True, n_nodes=Nr,
                smooth_iters=smooth_iters,
            )
            omega = jnp.asarray(omega_prep)
            keys = jax.random.split(key, R)
            Y0s = jnp.stack([
                riemannian.generate_initialization(
                    inst["lb"], inst["ub"], omega, dim,
                    key=None if i == 0 else keys[i],
                )
                for i in range(R)
            ])
            batch_shape = inst["D_goal"].shape[:-2]

            def fold(x):
                inner = x.shape[len(batch_shape):]
                x = jnp.broadcast_to(x, (R,) + batch_shape + inner)
                return x.reshape((-1,) + inner)

            D_goal_f = fold(inst["D_goal"])
            Y0_f = Y0s.reshape((-1,) + Y0s.shape[1 + len(batch_shape):])
            T_goal_f = fold(jnp.asarray(T_goal, dtype=Y0s.dtype))
            return Y0_f, D_goal_f, T_goal_f

    @jax.jit
    def stage_solve(Y0_f, D_goal_f):
        with jax.default_matmul_precision("highest"):
            return api.solve_reduced(
                structure, Y0_f, D_goal_f, omega_np, psi_L, psi_U,
                params=params, use_limits=use_limits,
            )

    def stage_finish(sol, T_goal_f, batch_len):
        with jax.default_matmul_precision("highest"):
            q = structure.joint_variables(sol["Y"], T_goal_f)
            pos_fk = structure.realization(q)
            viol, ok = structure.check_distance_limits(pos_fk)
            e_pos, e_rot = api.pose_error(structure, q, T_goal_f)
            if polish:
                q, e_pos, e_rot, viol, ok = api.polish_solution(
                    structure, q, T_goal_f, e_pos, e_rot, viol, ok,
                    params=polish_params,
                )
            all_out = {
                "q": q,
                "Y": sol["Y"],
                "cost": sol["cost"],
                "gradnorm": sol["gradnorm"],
                "iterations": sol["iterations"],
                "e_pos": e_pos,
                "e_rot": e_rot,
                "limit_violation": viol,
                "success": ok,
            }
            all_out = {
                k: v.reshape((R, batch_len) + v.shape[1:])
                for k, v in all_out.items()
            }
            return _select_best_restart(all_out)

    _finish_cache = {}  # batch_len is a Python static: one jit per shape

    def solver(T_goal, key):
        T_goal = jnp.asarray(T_goal)
        Y0_f, D_goal_f, T_goal_f = stage_prepare(T_goal, key)
        sol = stage_solve(Y0_f, D_goal_f)
        batch_len = Y0_f.shape[0] // R
        fn = _finish_cache.get(batch_len)
        if fn is None:
            fn = jax.jit(lambda s, t: stage_finish(s, t, batch_len))
            _finish_cache[batch_len] = fn
        return fn(sol, T_goal_f)

    return solver


def summarize(out, criterion_pos: float = 1e-3, criterion_rot: float = np.pi / 180):
    """Batch metrics: success rate and latency percentiles proxy (iterations).

    Success = pose error within (pos < 1 mm, rot < 1 deg by default) AND
    limit-feasible - the BASELINE.md target criterion.
    """
    e_pos = jnp.ravel(out["e_pos"])
    e_rot = jnp.ravel(out["e_rot"])
    ok = jnp.ravel(out["success"])
    hit = (e_pos < criterion_pos) & (e_rot < criterion_rot) & ok
    iters = jnp.ravel(out["iterations"]).astype(jnp.float32)
    return {
        "success_rate": jnp.mean(hit.astype(jnp.float32)),
        "pose_only_rate": jnp.mean(
            ((e_pos < criterion_pos) & (e_rot < criterion_rot)).astype(jnp.float32)
        ),
        "mean_pos_err": jnp.mean(e_pos),
        "median_pos_err": jnp.median(e_pos),
        "mean_iterations": jnp.mean(iters),
        "p90_iterations": jnp.percentile(iters, 90),
    }
