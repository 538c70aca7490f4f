"""Joint-space local solver: batched Levenberg-Marquardt on the pose residual.

Batched counterpart of the reference's scipy-SLSQP LocalSolver
(/root/reference/graphik/solvers/joint_angle_solver.py): the cost is the
body-frame pose log residual e = log(T(q)^-1 T_goal) with the analytic
Jacobian J_e = inv_left_jacobian(e) Ad(T^-1) J (joint_angle_solver.py:70-81,
128-150); spherical-obstacle constraints become hinge residuals with
position Jacobians (joint_angle_solver.py:83-126). SLSQP's sequential QPs
are replaced by a damped Gauss-Newton (LM) loop with joint-limit clipping -
fully batched and jittable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.ops.linalg import spd_solve_unrolled
from graphik_tpu.robots import kinematics
from graphik_tpu.utils import lie


@dataclasses.dataclass(frozen=True)
class LocalParams:
    maxiter: int = 100
    lm_init: float = 1e-3
    lm_up: float = 3.0
    lm_down: float = 0.5
    tol_grad: float = 1e-9
    clip_limits: bool = True
    # Obstacle constraints: augmented Lagrangian (multiplier) loop around
    # the LM core - feasibility is ENFORCED at convergence, unlike a fixed
    # penalty weight. al_iters outer rounds; rho multiplies by al_growth.
    al_iters: int = 4
    al_rho0: float = 100.0
    al_growth: float = 10.0


def _pose_residual(tpl, ee, T_goal, q):
    """Body-frame pose residual and its Jacobian: (tw,) / (tw, n)."""
    if tpl.dim == 3:
        T = kinematics.pose(tpl, q, ee)
        J = kinematics.jacobian(tpl, q, ee)  # spatial, (6, n)
        T_inv = lie.se3_inv(T)
        e = lie.se3_log(T_inv @ T_goal)
        J_e = lie.se3_inv_left_jacobian(e) @ lie.se3_adjoint(T_inv) @ J
        # d(e)/dq = -J_e per the chain rule through T(q)
        # (joint_angle_solver.py:79: jac = -2 J_e^T e for cost e^T e)
        return e, -J_e

    # Planar: residual via se2_log; Jacobian by forward-mode AD (n is tiny).
    def res(qq):
        T = kinematics.pose(tpl, qq, ee)
        return lie.se2_log(lie.se2_inv(T) @ T_goal)

    return res(q), jax.jacfwd(res)(q)


def _stacked_pose_residuals(tpl, T_goal, q):
    """Concatenate pose residuals over every end effector.

    T_goal: (n_ee, hd, hd). Returns ((tw * n_ee,), (tw * n_ee, n)).
    """
    es, Js = [], []
    for e_idx, ee in enumerate(tpl.ee):
        e, J = _pose_residual(tpl, int(ee), T_goal[e_idx], q)
        es.append(e)
        Js.append(J)
    return jnp.concatenate(es), jnp.concatenate(Js, axis=0)


def _obstacle_pairs(ps: ProblemStructure):
    """Static (node_idx (m,), centers (m, dim), radii (m,)) numpy arrays."""
    idx, cen, rad = [], [], []
    for center, radius in ps.obstacles:
        for i in range(1, ps.n + 1):
            idx.append(ps.idx_p(i))
            cen.append(np.asarray(center)[: ps.dim])
            rad.append(radius)
    return (
        np.asarray(idx, np.int32),
        np.asarray(cen, np.float64),
        np.asarray(rad, np.float64),
    )


def _obstacle_g_and_jac(ps: ProblemStructure, tpl, q, node_idx, centers,
                        radii):
    """Violations g = r - ||c - p_i(q)|| and analytic dg/dq.

    Uses the one-pass world-frame position Jacobians
    (kinematics.linear_jacobians) instead of per-constraint forward-mode AD
    (the reference recomputes pose+jacobian per constraint,
    joint_angle_solver.py:83-126). Returns (g (m,), Jg (m, n)).
    """
    pos = ps.realization(q)            # (N, dim)
    J_all = kinematics.linear_jacobians(tpl, q)  # (n+1, dim, n)
    p = pos[node_idx]                  # (m, dim)
    c = jnp.asarray(centers, q.dtype)
    r = jnp.asarray(radii, q.dtype)
    diff = c - p
    dist = jnp.sqrt(jnp.sum(diff * diff, axis=-1) + 1e-30)
    g = r - dist
    # d(-dist)/dq = (c - p)^T/dist . dp/dq
    u = diff / dist[:, None]
    Jg = jnp.einsum("md,mdn->mn", u, J_all[node_idx])
    return g, Jg


def solve_local(
    ps: ProblemStructure,
    T_goal,
    q0,
    params: LocalParams = LocalParams(),
):
    """Batched joint-space solve over all end effectors.

    Damped Gauss-Newton (LM) on the pose log residual; spherical-obstacle
    inequality constraints via an augmented-Lagrangian outer loop (the
    multipliers make feasibility exact at convergence, replacing the
    reference's SLSQP constraint handling, joint_angle_solver.py:83-126).

    T_goal: (..., hd, hd) or (..., n_ee, hd, hd); q0: (..., n).
    Returns dict(q, cost, iterations, max_violation).
    """
    tpl = ps.template
    dt = jnp.asarray(q0).dtype
    lb = jnp.asarray(tpl.lb[1:], dtype=dt)
    ub = jnp.asarray(tpl.ub[1:], dtype=dt)
    m = ps.n_obstacles * ps.n
    if m:
        node_idx, centers, radii = _obstacle_pairs(ps)

    def residuals(q, Tg, mult, rho):
        e, J_e = _stacked_pose_residuals(tpl, Tg, q)
        if m:
            g, Jg = _obstacle_g_and_jac(ps, tpl, q, node_idx, centers, radii)
            # AL term (rho/2) max(0, g + mult/rho)^2 as a least-squares
            # residual sqrt(rho/2) max(0, g + mult/rho).
            ghat = g + mult / rho
            act = ghat > 0
            w = jnp.sqrt(rho / 2.0)
            r_obs = w * jnp.where(act, ghat, 0.0)
            J_obs = w * jnp.where(act[:, None], Jg, 0.0)
            return jnp.concatenate([e, r_obs]), jnp.concatenate(
                [J_e, J_obs], axis=0
            )
        return e, J_e

    def lm_solve(q_init, Tg, mult, rho):
        def cond(s):
            q, lam, k, done = s
            return (~done) & (k < params.maxiter)

        def body(s):
            q, lam, k, done = s
            r, J = residuals(q, Tg, mult, rho)
            g = J.T @ r
            H = J.T @ J + lam * jnp.eye(tpl.n, dtype=dt)
            step = -spd_solve_unrolled(H, g)
            q_new = q + step
            if params.clip_limits:
                q_new = jnp.clip(q_new, lb, ub)
            r_new, _ = residuals(q_new, Tg, mult, rho)
            improved = jnp.sum(r_new**2) < jnp.sum(r**2)
            q_out = jnp.where(improved, q_new, q)
            lam_new = jnp.where(
                improved, lam * params.lm_down, lam * params.lm_up
            )
            lam_new = jnp.clip(lam_new, 1e-12, 1e8)
            done_new = jnp.linalg.norm(g) < params.tol_grad
            return (q_out, lam_new, k + 1, done_new)

        q, lam, k, _ = jax.lax.while_loop(
            cond, body,
            (q_init, jnp.asarray(params.lm_init, dt),
             jnp.zeros((), jnp.int32), jnp.zeros((), bool)),
        )
        return q, k

    def single(q_init, Tg):
        if m:
            def al_body(_, carry):
                q, mult, rho, iters = carry
                q, k = lm_solve(q, Tg, mult, rho)
                g, _ = _obstacle_g_and_jac(
                    ps, tpl, q, node_idx, centers, radii
                )
                # standard inequality multiplier update
                mult = jnp.maximum(0.0, mult + rho * g)
                return (q, mult, rho * params.al_growth, iters + k)

            q, mult, rho, iters = jax.lax.fori_loop(
                0, params.al_iters, al_body,
                (q_init, jnp.zeros((m,), dt),
                 jnp.asarray(params.al_rho0, dt), jnp.zeros((), jnp.int32)),
            )
            g, _ = _obstacle_g_and_jac(ps, tpl, q, node_idx, centers, radii)
            max_viol = jnp.max(jnp.maximum(g, 0.0))
        else:
            q, iters = lm_solve(
                q_init, Tg, jnp.zeros((0,), dt), jnp.asarray(1.0, dt)
            )
            max_viol = jnp.zeros((), dt)
        e, _ = _stacked_pose_residuals(tpl, Tg, q)
        return q, jnp.sum(e**2), iters, max_viol

    T_goal = jnp.asarray(T_goal, dtype=dt)
    q0 = jnp.asarray(q0)
    if T_goal.ndim == q0.ndim + 1:  # (..., hd, hd): add the ee axis
        T_goal = T_goal[..., None, :, :]

    fn = single
    for _ in range(q0.ndim - 1):
        fn = jax.vmap(fn)
    with jax.default_matmul_precision("highest"):
        q, cost, iters, max_viol = fn(q0, T_goal)
    return {
        "q": q,
        "cost": cost,
        "iterations": iters,
        "max_violation": max_viol,
    }
