"""High-level IK API: the batched equivalent of `solve_with_riemannian`.

Reference flow (riemannian_solver.py:220-234):
    graph.from_pose -> distance/adjacency matrices -> bound_smoothing ->
    RiemannianSolver.solve -> graph_from_pos -> joint_variables ->
    check_distance_limits.

Here the whole pipeline is one jittable, batched function: pass T_goal with
leading batch dims and every stage runs vmapped. Success is reported
per-instance via status flags instead of exceptions (SURVEY.md section 5).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.robots import kinematics
from graphik_tpu.solvers import local as local_solver
from graphik_tpu.solvers import riemannian
from graphik_tpu.solvers.local import LocalParams
from graphik_tpu.solvers.riemannian import TRParams
from graphik_tpu.utils import lie


def pose_error(structure: ProblemStructure, q, T_goal):
    """Per-instance position / rotation error of the end effector(s).

    Matches the experiment metrics (test_chain_2d_new.py:63-66): position
    error is the translation norm; rotation error is the norm of the
    rotation part of log(T_goal T_sol^-1).

    Runs at HIGHEST matmul precision regardless of caller scope: float32
    matmuls may otherwise run in TF32 (~3 decimal digits), where the FK
    chain and the R_goal R_sol^T product carry ~1e-3 relative noise,
    turning a converged mm-accurate solution into an apparent failure.
    """
    with jax.default_matmul_precision("highest"):
        return _pose_error_impl(structure, q, T_goal)


def _pose_error_impl(structure: ProblemStructure, q, T_goal):
    tpl = structure.template
    q = jnp.asarray(q)
    T_goal = jnp.asarray(T_goal, dtype=q.dtype)
    n_ee = len(tpl.ee)
    if T_goal.shape[-3:-2] != (n_ee,) or T_goal.ndim < 3:
        T_goal = T_goal[..., None, :, :]

    T_all = kinematics.all_poses(tpl, q)
    dim = tpl.dim
    e_pos = []
    e_rot = []
    for e, ee in enumerate(tpl.ee):
        T_sol = T_all[..., int(ee), :, :]
        Tg = T_goal[..., e, :, :]
        e_pos.append(
            jnp.linalg.norm(Tg[..., :dim, dim] - T_sol[..., :dim, dim], axis=-1)
        )
        R_rel = jnp.einsum(
            "...ij,...kj->...ik", Tg[..., :dim, :dim], T_sol[..., :dim, :dim]
        )
        if dim == 3:
            e_rot.append(jnp.linalg.norm(lie.so3_log(R_rel), axis=-1))
        else:
            e_rot.append(jnp.abs(jnp.arctan2(R_rel[..., 1, 0], R_rel[..., 0, 0])))
    e_pos = jnp.stack(e_pos, axis=-1)
    e_rot = jnp.stack(e_rot, axis=-1)
    return jnp.max(e_pos, axis=-1), jnp.max(e_rot, axis=-1)


def solve_ik(
    structure: ProblemStructure,
    T_goal,
    params: TRParams = TRParams(),
    use_limits: bool = True,
    Y_init=None,
    dtype=None,
    limit_tol: float = 1e-6,
    polish: bool = True,
    polish_params: Optional[LocalParams] = None,
    smooth_iters: Optional[int] = None,
):
    """Solve batched IK instances with the Riemannian solver.

    Parameters
    ----------
    structure : compiled problem template (static).
    T_goal : (..., hd, hd) or (..., n_ee, hd, hd) goal poses; leading dims
        are the instance batch.
    Y_init : optional (..., N, dim) initialization; default is the
        bound-smoothing MDS init (riemannian_solver.py:67-75).

    Returns a dict with per-instance arrays:
      q (..., n), Y (..., N, dim), cost, gradnorm, iterations,
      e_pos, e_rot, limit_violation, success (limits ok).
    """
    # float32 matmuls may run in TF32 unless HIGHEST is asked for;
    # distance-geometry optimization needs true f32 accumulation. Scoped so
    # library users are unaffected.
    with jax.default_matmul_precision("highest"):
        return _solve_ik_impl(
            structure, T_goal, params, use_limits, Y_init, dtype, limit_tol,
            polish, polish_params, smooth_iters,
        )


def _solve_ik_impl(structure, T_goal, params, use_limits, Y_init, dtype, limit_tol,
                   polish, polish_params, smooth_iters=None):
    spec = structure.reduced_spec()
    Nr = spec["Nr"] if (spec is not None and Y_init is None) else None
    inst = structure.instance(
        T_goal, dtype=dtype, smooth=Y_init is None, n_nodes=Nr,
        smooth_iters=smooth_iters,
    )
    omega_np, psi_L, psi_U = structure.masks()
    dim = structure.dim

    if Y_init is None:
        om = omega_np if Nr is None else omega_np[:Nr, :Nr]
        Y0 = riemannian.generate_initialization(
            inst["lb"], inst["ub"], jnp.asarray(om), dim
        )
    else:
        Y0 = jnp.asarray(Y_init)
        batch = inst["D_goal"].shape[:-2]
        Y0 = jnp.broadcast_to(Y0, batch + Y0.shape[-2:])

    sol = solve_reduced(
        structure, Y0, inst["D_goal"], omega_np, psi_L, psi_U,
        params=params, use_limits=use_limits,
    )

    q = structure.joint_variables(sol["Y"], T_goal)
    pos_fk = structure.realization(q)
    max_viol, limits_ok = structure.check_distance_limits(pos_fk, tol=limit_tol)
    e_pos, e_rot = pose_error(structure, q, T_goal)

    if polish:
        q, e_pos, e_rot, max_viol, limits_ok = polish_solution(
            structure, q, T_goal, e_pos, e_rot, max_viol, limits_ok,
            limit_tol=limit_tol, params=polish_params,
        )

    return {
        "q": q,
        "Y": sol["Y"],
        "cost": sol["cost"],
        "gradnorm": sol["gradnorm"],
        "iterations": sol["iterations"],
        "num_inner": sol["num_inner"],
        "e_pos": e_pos,
        "e_rot": e_rot,
        "limit_violation": max_viol,
        "success": limits_ok,
    }


def solve_reduced(
    structure,
    Y0,
    D_goal,
    omega_np,
    psi_L,
    psi_U,
    params: TRParams = TRParams(),
    use_limits: bool = True,
):
    """Riemannian solve with the anchored-obstacle reduction.

    Obstacle nodes have compile-time-constant positions, so they are removed
    from the variable set and their bound edges become anchored hinge terms
    (ProblemStructure.reduced_spec). The returned Y is padded back to the
    full node count with the constant obstacle positions, so downstream
    consumers (joint recovery, validation, visualization) see the same
    layout as the full formulation.

    Solver selection follows the reference's params["solver"] switch
    (riemannian_solver.py:41-59): pass TRParams for the trust-region
    solver, CGParams for the conjugate-gradient one.
    """
    solve_fn = (
        riemannian.solve_cg
        if isinstance(params, riemannian.CGParams)
        else riemannian.solve
    )
    spec = structure.reduced_spec()
    if spec is None:
        return solve_fn(
            Y0, D_goal, omega_np,
            psi_L if use_limits else None,
            psi_U if use_limits else None,
            params=params,
        )
    Nr = spec["Nr"]
    # Inputs may already be reduced (instance(n_nodes=Nr)) or full-graph.
    sol = solve_fn(
        Y0[..., :Nr, :],
        D_goal[..., :Nr, :Nr],
        omega_np[:Nr, :Nr],
        psi_L[:Nr, :Nr] if use_limits else None,
        psi_U[:Nr, :Nr] if use_limits else None,
        params=params,
        anchors=spec if use_limits else None,
    )
    Yr = sol["Y"]
    obs_pos = jnp.broadcast_to(
        jnp.asarray(structure.pos_fixed[Nr:], dtype=Yr.dtype),
        Yr.shape[:-2] + (structure.N - Nr, structure.dim),
    )
    sol["Y"] = jnp.concatenate([Yr, obs_pos], axis=-2)
    return sol


def polish_solution(
    structure,
    q,
    T_goal,
    e_pos,
    e_rot,
    max_viol,
    limits_ok,
    limit_tol: float = 1e-6,
    params: Optional[LocalParams] = None,
):
    """Joint-space Gauss-Newton polish (SURVEY.md section 7.2 step 8).

    The Riemannian solve lands in the right basin at f32 gradient-noise
    accuracy (~cm); a few LM steps on the pose log residual drive the error
    to f32 machine precision. Polished q is taken per instance only when it
    stays limit/obstacle-feasible and improves pose error.

    Returns (q, e_pos, e_rot, max_viol, limits_ok) with per-instance
    selection between the input and polished solutions.
    """
    # Pin f32 matmul precision: callers outside a highest-precision scope
    # (e.g. a bare jit around a CIDGIK finish stage) could otherwise run
    # the FK/validation matmuls in reduced precision (TF32), where the
    # distance-limit check misclassifies feasible solutions as violating
    # by ~1e-3 of pure FK noise (exact in f64).
    with jax.default_matmul_precision("highest"):
        pp = params or LocalParams(maxiter=30, tol_grad=1e-8)
        pol = local_solver.solve_local(structure, T_goal, q, pp)
        q_p = pol["q"]
        viol_p, ok_p = structure.check_distance_limits(
            structure.realization(q_p), tol=limit_tol
        )
        e_pos_p, e_rot_p = pose_error(structure, q_p, T_goal)
    big = jnp.asarray(1e3, e_pos.dtype)
    score0 = e_pos + e_rot + jnp.where(limits_ok, 0.0, big)
    score1 = e_pos_p + e_rot_p + jnp.where(ok_p, 0.0, big)
    take = score1 < score0
    q = jnp.where(take[..., None], q_p, q)
    e_pos = jnp.where(take, e_pos_p, e_pos)
    e_rot = jnp.where(take, e_rot_p, e_rot)
    max_viol = jnp.where(take, viol_p, max_viol)
    limits_ok = jnp.where(take, ok_p, limits_ok)
    return q, e_pos, e_rot, max_viol, limits_ok


def solve_ik_jit(structure: ProblemStructure, **fixed_kwargs):
    """Return a jitted solver specialized to `structure`.

    Example:
        solver = solve_ik_jit(structure, params=TRParams(maxiter=500))
        out = solver(T_goal_batch)
    """
    fn = partial(solve_ik, structure, **fixed_kwargs)
    return jax.jit(fn)


def make_solver(
    structure: ProblemStructure,
    params: TRParams = TRParams(),
    use_limits: bool = True,
    dtype=None,
    limit_tol: float = 1e-6,
    polish: bool = True,
    polish_params: Optional[LocalParams] = None,
    smooth_iters: Optional[int] = None,
    init_method: str = riemannian.DEFAULT_INIT,
):
    """Stage-jitted solver: same result as solve_ik_jit, far cheaper compile.

    XLA compile time for the monolithic pipeline program is superlinear in
    program size (it once took minutes where the individual stages compile
    in seconds), so the pipeline is jitted as three
    stages - (instance+init), solve, (recover+validate+polish) - chained on
    the host. Stage boundaries carry batched device arrays; the host
    round-trips are dispatch-only (no transfers). The jitted stages are
    exposed as `solver.stages` (prepare, solve, finish) for profiling.
    """
    omega_np, psi_L, psi_U = structure.masks()
    dim = structure.dim
    spec = structure.reduced_spec()
    Nr = spec["Nr"] if spec is not None else None
    omega_prep = omega_np if Nr is None else omega_np[:Nr, :Nr]

    @jax.jit
    def stage_prepare(T_goal):
        with jax.default_matmul_precision("highest"):
            # Reduced-node assembly: bound smoothing and the MDS init scale
            # cubically with node count, so obstacle-constant nodes are
            # excluded here (they re-enter as solver hinges + validation).
            inst = structure.instance(
                T_goal, dtype=dtype, smooth=True, n_nodes=Nr,
                smooth_iters=smooth_iters,
            )
            Y0 = riemannian.generate_initialization(
                inst["lb"], inst["ub"], jnp.asarray(omega_prep), dim,
                method=init_method,
            )
            return inst["D_goal"], Y0

    @jax.jit
    def stage_solve(Y0, D_goal):
        with jax.default_matmul_precision("highest"):
            return solve_reduced(
                structure, Y0, D_goal, omega_np, psi_L, psi_U,
                params=params, use_limits=use_limits,
            )

    @jax.jit
    def stage_finish(Y, T_goal, sol):
        with jax.default_matmul_precision("highest"):
            q = structure.joint_variables(Y, T_goal)
            pos_fk = structure.realization(q)
            max_viol, limits_ok = structure.check_distance_limits(
                pos_fk, tol=limit_tol
            )
            e_pos, e_rot = pose_error(structure, q, T_goal)
            if polish:
                q, e_pos, e_rot, max_viol, limits_ok = polish_solution(
                    structure, q, T_goal, e_pos, e_rot, max_viol, limits_ok,
                    limit_tol=limit_tol, params=polish_params,
                )
            return {
                "q": q,
                "Y": Y,
                "e_pos": e_pos,
                "e_rot": e_rot,
                "limit_violation": max_viol,
                "success": limits_ok,
                **{k: sol[k] for k in
                   ("cost", "gradnorm", "iterations", "num_inner")},
            }

    def solver(T_goal):
        T_goal = jnp.asarray(T_goal)
        D_goal, Y0 = stage_prepare(T_goal)
        sol = stage_solve(Y0, D_goal)
        Tg = T_goal.astype(sol["Y"].dtype)
        return stage_finish(sol["Y"], Tg, sol)

    solver.stages = {
        "prepare": stage_prepare, "solve": stage_solve, "finish": stage_finish,
    }
    return solver


def random_goals(structure: ProblemStructure, key, batch_shape=()):
    """Random reachable goal poses via FK at random configurations.

    The experiments' goal generator (test_chain_2d_new.py:52-53).
    Returns (T_goal, q_goal): T_goal is (..., n_ee, hd, hd).
    """
    tpl = structure.template
    q = kinematics.random_configuration(tpl, key, batch_shape)
    T_all = kinematics.all_poses(tpl, q)
    T_goal = T_all[..., jnp.asarray(tpl.ee), :, :]
    return T_goal, q
