"""Tune the feasibility-aware residual stop (TRParams.res_tol) on the GPU.

For each (res_tol, maxiter) candidate: solve a 4096 batch of UR10 goals
through the production pipeline (fused Pallas TR + GN polish), report
success rate at the BASELINE criterion, mean iterations, and wall-clock
throughput. Run:  python tools/res_tol_sweep.py [config]
"""

import json
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np
import jax

from graphik_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

from graphik_tpu import api
from graphik_tpu.robots import library
from graphik_tpu.solvers.local import LocalParams
from graphik_tpu.solvers.riemannian import TRParams
from graphik_tpu.parallel.mesh import summarize


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "ur10"
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    if name == "ur10":
        ps = library.load_ur10()[1]
    elif name == "kuka_iiwa":
        ps = library.load_kuka()[1]
    elif name == "lwa4d":
        ps = library.load_schunk_lwa4d()[1]
    elif name == "ur10_table":
        from graphik_tpu.graphs.problem import ProblemStructure
        from graphik_tpu.utils.environments import table_environment

        tpl = library.load_ur10()[0]
        ps = ProblemStructure.from_template(tpl, obstacles=table_environment())
    else:
        raise SystemExit(f"unknown config {name}")

    @jax.jit
    def gen(key):
        return api.random_goals(ps, key, (batch,))[0]

    polish = LocalParams(maxiter=10, tol_grad=1e-8)
    # mirror the bench operating point (production preset, smooth_iters=2)
    # so the sweep answers the question bench.py actually poses; 100 is the
    # round-4 production maxiter, 150 the r3 one.
    grid = []
    for mi in (100, 150):
        for rt in (0.0, 1e-3, 2e-3, 3e-3, 5e-3, 1e-2):
            grid.append((mi, rt))

    T_goal = gen(jax.random.PRNGKey(0))
    jax.block_until_ready(T_goal)
    T_eval = gen(jax.random.PRNGKey(1))
    jax.block_until_ready(T_eval)

    for mi, rt in grid:
        params = TRParams.production(maxiter=mi, maxinner=24, res_tol=rt)
        solver = api.make_solver(ps, params=params, polish_params=polish,
                                 smooth_iters=2)
        t0 = time.perf_counter()
        out = solver(T_goal)
        jax.block_until_ready(out)
        np.asarray(out["e_pos"])
        compile_s = time.perf_counter() - t0
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = solver(T_eval)
            jax.block_until_ready(out)
            np.asarray(out["e_pos"])
            walls.append(time.perf_counter() - t0)
        wall = min(walls)
        stats = {k: float(v) for k, v in summarize(out).items()}
        rec = {
            "config": name,
            "maxiter": mi,
            "res_tol": rt,
            "success": round(stats["success_rate"], 4),
            "mean_iter": round(stats["mean_iterations"], 1),
            "p90_iter": round(stats["p90_iterations"], 1),
            "wall_s": round(wall, 3),
            "solves_per_s": round(batch / wall, 1),
            "eff_solves_per_s": round(batch / wall * stats["success_rate"], 1),
            "compile_s": round(compile_s, 1),
        }
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
