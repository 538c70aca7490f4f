"""Stage-by-stage wall-time profile of the solve_ik pipeline on the live device."""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import time, sys
import numpy as np
import jax, jax.numpy as jnp
from graphik_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

from graphik_tpu import api
from graphik_tpu.robots.library import load_ur10
from graphik_tpu.solvers.riemannian import TRParams, generate_initialization, solve as rsolve
from graphik_tpu.solvers import local as local_solver

def sync(tree):
    jax.block_until_ready(tree)
    np.asarray(jax.tree_util.tree_leaves(tree)[0]).ravel()[:1]

def timeit(name, fn, *args, reps=3):
    t0=time.perf_counter(); out = fn(*args); sync(out)
    tc = time.perf_counter()-t0
    t0 = time.perf_counter()
    for _ in range(reps): out = fn(*args)
    sync(out)
    dt=(time.perf_counter()-t0)/reps
    print(f"{name:40s} compile+1st={tc:8.2f}s  steady={dt*1e3:10.2f} ms", flush=True)
    return out

B = int(sys.argv[1]) if len(sys.argv)>1 else 1024
maxiter = int(sys.argv[2]) if len(sys.argv)>2 else 400
tpl, ps = load_ur10()
key = jax.random.PRNGKey(0)
T_goal, _ = api.random_goals(ps, key, (B,))
T_goal = jnp.asarray(T_goal); sync(T_goal)
omega, psi_L, psi_U = ps.masks()
params = TRParams(maxiter=maxiter)

@jax.jit
def stage_inst(Tg):
    return ps.instance(Tg, smooth=True)
inst = timeit("instance (goal insert + smoothing)", stage_inst, T_goal)

@jax.jit
def stage_init(lb, ub):
    return generate_initialization(lb, ub, jnp.asarray(omega), ps.dim)
Y0 = timeit("MDS init", stage_init, inst["lb"], inst["ub"])

@jax.jit
def stage_solve(Y0, Dg):
    with jax.default_matmul_precision("highest"):
        return rsolve(Y0, Dg, omega, psi_L, psi_U, params=params)
sol = timeit("riemannian TR solve", stage_solve, Y0, inst["D_goal"], reps=1)
print("  mean iters:", float(sol["iterations"].mean()), " mean inner:", float(sol["num_inner"].mean()))

@jax.jit
def stage_jv(Y, Tg):
    return ps.joint_variables(Y, Tg)
q = timeit("joint_variables", stage_jv, sol["Y"], T_goal)

@jax.jit
def stage_check(q):
    pos = ps.realization(q)
    return ps.check_distance_limits(pos)
timeit("realization+check", stage_check, q)

@jax.jit
def stage_perr(q, Tg):
    return api.pose_error(ps, q, Tg)
ep, er = timeit("pose_error", stage_perr, q, T_goal)

@jax.jit
def stage_polish(q, Tg):
    with jax.default_matmul_precision("highest"):
        mv, ok = ps.check_distance_limits(ps.realization(q))
        e_p, e_r = api.pose_error(ps, q, Tg)
        return api.polish_solution(ps, q, Tg, e_p, e_r, mv, ok)
timeit("polish (LM 30)", stage_polish, q, T_goal)
