"""CIDGIK success-rate sweep (f64 CPU oracle).

Runs >=256-goal sweeps of dense + sparse CIDGIK on UR10 and LWA4D (CPU
f64, batched) and records success rates at the reference criterion
(pos/rot err < 0.01, convex_iteration.py's evaluation) plus feasibility
statistics. Writes CIDGIK_SWEEP.json.

Usage: python tools/cidgik_sweep.py [--goals 256] [--robots ur10,lwa4d]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

os.environ["JAX_PLATFORMS"] = "cpu"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--goals", type=int, default=256)
    ap.add_argument("--robots", type=str, default="ur10,lwa4d")
    ap.add_argument("--modes", type=str, default="dense,sparse",
                    help="comma list: dense,sparse")
    ap.add_argument("--out", type=str, default="CIDGIK_SWEEP.json")
    ap.add_argument("--rho", type=float, default=1.0,
                    help="ADMM penalty (production uses 10; round-5 sweep)")
    ap.add_argument("--suffix", type=str, default="",
                    help="row-key suffix; merges into --out instead of "
                         "overwriting when set")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from graphik_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    import numpy as np
    import jax.numpy as jnp

    from graphik_tpu import api
    from graphik_tpu.robots import library
    from graphik_tpu.solvers import cidgik as cd
    from graphik_tpu.solvers import cidgik_sparse as cs
    from graphik_tpu.solvers.cidgik import CidgikParams

    # Oracle-grade budget, sized so the 2-vCPU f64 sweep finishes in ~1 h:
    # 20-sweep Jacobi eigendecompositions (converged to ~1e-15 for these
    # block sizes; XLA's own batched eigh both NaNs on zero-padded stacks
    # and takes pathologically long to compile inside while x scan x vmap),
    # 1600 ADMM iterations per outer solve, outer loop to eig-sum
    # convergence (the reference's MOSEK analogue is its 1e-6 interior
    # point, sdp_formulations.py:9-43).
    params = CidgikParams(admm_iters=1600, max_outer=16, rel_tol=1e-5,
                          eigh_sweeps=20, rho=args.rho)

    def feasible_goals(ps, key, n):
        """FK-certified goals whose generating configuration clears the
        obstacles (rejection sampling; the reference's obstacle
        experiments use feasible targets the same way)."""
        got_T = []
        k = key
        while sum(len(t) for t in got_T) < n:
            k, sub = jax.random.split(k)
            T, q = api.random_goals(ps, sub, (2 * n,))
            _, ok = jax.vmap(
                lambda qi: ps.check_distance_limits(ps.realization(qi))
            )(q)
            got_T.append(np.asarray(T)[np.asarray(ok)])
        return jnp.asarray(np.concatenate(got_T, axis=0)[:n])

    results = {}
    for name in args.robots.split(","):
        if name.endswith("_table"):
            from graphik_tpu.graphs.problem import ProblemStructure
            from graphik_tpu.utils.environments import table_environment

            base = name[:-len("_table")]
            tpl = getattr(library, f"load_{base}" if base != "lwa4d"
                          else "load_schunk_lwa4d")()[0]
            ps = ProblemStructure.from_template(
                tpl, obstacles=table_environment()
            )
            T_goal = feasible_goals(ps, jax.random.PRNGKey(42), args.goals)
        else:
            ps = getattr(library, f"load_{name}" if name != "lwa4d"
                         else "load_schunk_lwa4d")()[1]
            T_goal, _ = api.random_goals(
                ps, jax.random.PRNGKey(42), (args.goals,)
            )
            T_goal = jnp.asarray(T_goal)

        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            if mode == "dense":
                comp = cd.compile_cidgik(ps)
                out = cd.solve_cidgik(comp, T_goal, params=params)
            else:
                comp = cs.compile_cidgik_sparse(ps)
                out = cs.solve_cidgik_sparse(comp, T_goal, params=params)
            e_pos, e_rot = api.pose_error(ps, out["q"], T_goal)
            wall = time.perf_counter() - t0
            e_pos = np.asarray(e_pos)
            e_rot = np.asarray(e_rot)
            hit = (e_pos < 1e-2) & (e_rot < 1e-2)
            feas = np.asarray(out["status"]) == cd.FEASIBLE
            _, clear = jax.vmap(
                lambda qi: ps.check_distance_limits(ps.realization(qi))
            )(out["q"])
            clear = np.asarray(clear)
            key = f"{name}_{mode}{args.suffix}"
            results[key] = {
                "goals": args.goals,
                "success_rate_1cm": round(float(hit.mean()), 4),
                "success_rate_1mm": round(
                    float(((e_pos < 1e-3) & (e_rot < np.pi / 180)).mean()), 4
                ),
                "feasible_rate": round(float(feas.mean()), 4),
                "clear_rate": round(float(clear.mean()), 4),
                "median_pos_err": float(np.median(e_pos)),
                "median_eig_sum": float(np.median(np.asarray(out["eig_sum"]))),
                "wall_s": round(wall, 1),
            }
            print(f"{key}: {results[key]}", file=sys.stderr, flush=True)

    if args.suffix and os.path.exists(args.out):
        with open(args.out) as f:
            merged = json.load(f)
        merged.update(results)
        results = merged
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
