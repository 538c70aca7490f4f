"""Sweep CIDGIK ADMM/outer budgets on the GPU: final-accuracy vs throughput.

The GN polish recovers mm accuracy from basin-level ADMM output, so the
question is how small the ADMM budget can get before the basin quality
(and thus the polished success rate) degrades.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


import json
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from graphik_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from graphik_tpu import api
    from graphik_tpu.robots import library
    from graphik_tpu.solvers import cidgik as cd
    from graphik_tpu.solvers.cidgik import CidgikParams

    B = 256
    ps = library.load_ur10()[1]
    comp = cd.compile_cidgik(ps)
    T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(0), (B,))
    T_goal = jnp.asarray(T_goal)

    def run(tag, cparams):
        def pipeline(Tg):
            out = cd.solve_cidgik(comp, Tg, params=cparams)
            e0 = api.pose_error(ps, out["q"], Tg)
            viol, ok = ps.check_distance_limits(ps.realization(out["q"]))
            q, ep, er, viol, ok = api.polish_solution(
                ps, out["q"], Tg, e0[0], e0[1], viol, ok
            )
            return e0[0], ep, er

        solver = jax.jit(pipeline)
        res = solver(T_goal)
        np.asarray(res[0])  # fence compile+run
        t0 = time.perf_counter()
        res = solver(T_goal)
        e0, ep, er = (np.asarray(x) for x in res)
        wall = time.perf_counter() - t0
        print(json.dumps({
            "tag": tag,
            "wall_s": round(wall, 2),
            "solves_per_sec": round(B / wall, 1),
            "raw_1cm": round(float((e0 < 1e-2).mean()), 4),
            "polished_1cm": round(float(((ep < 1e-2) & (er < 1e-2)).mean()), 4),
            "polished_1mm": round(
                float(((ep < 1e-3) & (er < np.deg2rad(1))).mean()), 4),
        }), flush=True)

    run("800x8", CidgikParams(admm_iters=800, max_outer=8))
    run("400x6", CidgikParams(admm_iters=400, max_outer=6))
    run("300x4", CidgikParams(admm_iters=300, max_outer=4))
    run("200x4", CidgikParams(admm_iters=200, max_outer=4))


if __name__ == "__main__":
    main()
