"""Reference-parity harness: fix the success-rate denominator.

The reference itself cannot execute in this sandbox (pymanopt/cvxpy/
liegroups/numba are not installed and installs are disallowed), so the
denominator is measured by replicating the reference's exact harness
settings with this framework's faithful float64 reimplementation of the
same algorithm on CPU:

  * solver budgets: maxiter=3000, mingradnorm=5e-10, tCG maxinner=N*d
    (reference riemannian_solver.py:44-50, trust_region.py:118)
  * float64 dense cost path (the reference is float64 numpy/numba)
  * NO polish stage (the reference returns the raw Riemannian solution)
  * goals: FK at seeded random configurations
    (experiments/simple_ik_examples/test_chain_2d_new.py:52-53)
  * success criteria:
      - experiment criterion: pos err < 0.01 AND rot err < 0.01 AND
        joint limits respected (test_chain_2d_limits_new.py:73-77)
      - BASELINE criterion: pos err < 1 mm AND rot err < 1 deg AND feasible

Writes PARITY.json; tools/render_parity.py (or this script's --render) turns
it into PARITY.md. The GPU bench's success_rate divided by this table's
rate is the "fraction of reference success" BASELINE.md asks for.

Usage: python tools/reference_parity.py [--goals 100] [--configs a,b,...]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

os.environ["JAX_PLATFORMS"] = "cpu"

CONFIGS = [
    "planar6", "planar6_limits", "planar10", "planar10_limits",
    "ur10", "kuka_iiwa", "lwa4d", "ur10_table",
]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--goals", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=100,
                    help="goals per solve batch (one compile, reused; "
                         "checkpoint after each chunk)")
    ap.add_argument("--configs", type=str, default=",".join(CONFIGS))
    ap.add_argument("--out", type=str, default="PARITY.json")
    ap.add_argument("--ckpt", type=str, default="/tmp/parity_ckpt")
    args = ap.parse_args()

    import jax

    # Pin the platform post-import as well (jax may already be imported
    # when this runs): the "f64 CPU" denominator must not run on a GPU.
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from graphik_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    import numpy as np
    import jax.numpy as jnp

    from graphik_tpu import api
    from graphik_tpu.robots import library
    from graphik_tpu.solvers.riemannian import TRParams

    def build(name):
        if name == "planar6":
            return library.load_planar_chain(6)[1]
        if name == "planar6_limits":
            return library.load_planar_chain(6, limits=np.pi / 2)[1]
        if name == "planar10":
            return library.load_planar_chain(10)[1]
        if name == "planar10_limits":
            return library.load_planar_chain(10, limits=np.pi / 2)[1]
        if name == "ur10":
            return library.load_ur10()[1]
        if name == "kuka_iiwa":
            return library.load_kuka()[1]
        if name == "lwa4d":
            return library.load_schunk_lwa4d()[1]
        if name == "ur10_table":
            from graphik_tpu.graphs.problem import ProblemStructure
            from graphik_tpu.utils.environments import table_environment

            ps = library.load_ur10()[1]
            return ProblemStructure.from_template(
                ps.template, obstacles=table_environment()
            )
        raise ValueError(name)

    # Reference budgets (riemannian_solver.py:44-50). Library DEFAULTS must
    # match reference stopping semantics (gradnorm/maxiter only, no plateau
    # or residual early-stops) - the tuned preset is opt-in via
    # TRParams.production(). Guard that contract here so a default change
    # fails the parity run loudly instead of silently shifting semantics.
    _d = TRParams()
    assert _d.plateau_every == 0 and _d.res_tol == 0.0, (
        "TRParams() defaults diverge from reference stopping semantics: "
        f"plateau_every={_d.plateau_every}, res_tol={_d.res_tol}"
    )
    params = TRParams(maxiter=3000, mingradnorm=5e-10, backend="dense")

    from graphik_tpu.utils import checkpoint, stats

    results = {}
    for name in args.configs.split(","):
        ps = build(name)
        t0 = time.perf_counter()
        T_goal, q_goal = api.random_goals(
            ps, jax.random.PRNGKey(1234), (args.goals,)
        )
        ck_path = os.path.join(args.ckpt, f"{name}_{args.goals}.npz")
        chunks, start = [], 0
        if os.path.exists(ck_path):
            st, meta = checkpoint.load_checkpoint(ck_path)
            start = int(meta.get("next", 0))
            chunks = [st[str(i)] for i in range(len(st))]
        solve = jax.jit(lambda Tg: api.solve_ik(
            ps, Tg, params=params, polish=False, dtype=jnp.float64,
        ))
        for lo in range(start, args.goals, args.chunk):
            hi = min(lo + args.chunk, args.goals)
            out = solve(jnp.asarray(T_goal)[lo:hi])
            chunks.append(np.stack([
                np.asarray(out["e_pos"], np.float64),
                np.asarray(out["e_rot"], np.float64),
                np.asarray(out["success"], np.float64),
                np.asarray(out["iterations"], np.float64),
            ]))
            checkpoint.save_checkpoint(
                ck_path, {str(i): c for i, c in enumerate(chunks)},
                {"next": hi},
            )
            print(f"[parity] {name} {hi}/{args.goals} "
                  f"t={time.perf_counter() - t0:.0f}s",
                  file=sys.stderr, flush=True)
        allc = np.concatenate(chunks, axis=1)
        e_pos, e_rot, feas, iters = allc[0], allc[1], allc[2] > 0, allc[3]
        n = e_pos.shape[0]
        crit_exp = (e_pos < 1e-2) & (e_rot < 1e-2) & feas
        crit_base = (e_pos < 1e-3) & (e_rot < np.pi / 180) & feas
        wall = time.perf_counter() - t0
        # alpha is the significance level: 0.05 -> 95% interval
        wil_lo, wil_hi = stats.wilson(n, int(crit_base.sum()), alpha=0.05)
        results[name] = {
            "goals": n,
            "success_rate_experiment": round(float(crit_exp.mean()), 4),
            "success_rate_baseline": round(float(crit_base.mean()), 4),
            "baseline_wilson_ci": [round(float(wil_lo), 4),
                                   round(float(wil_hi), 4)],
            "median_pos_err": float(np.median(e_pos)),
            "median_rot_err": float(np.median(e_rot)),
            "mean_iterations": round(float(iters.mean()), 1),
            "wall_s": round(wall, 1),
        }
        print(f"{name}: {results[name]}", file=sys.stderr, flush=True)

    meta = {
        "harness": "f64 CPU, maxiter=3000, mingradnorm=5e-10, no polish "
                   "(reference riemannian_solver.py budgets)",
        "seed": 1234,
        "results": results,
    }
    with open(args.out, "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


if __name__ == "__main__":
    main()
