"""Sweep the raw (un-polished) CIDGIK ADMM accuracy levers on the GPU.

The f32 ADMM alone solved fewer goals @1cm than the f64 oracle (PARITY.md)
on ur10 dense and on the table scene; the production success leans on the
GN polish. Levers:

  * more ADMM iterations / outer rounds (tighter SDP solves)
  * more Newton-Schulz iterations (the sign iteration is least accurate
    exactly where convex iteration drives eigenvalues -> 0)
  * a second iterative-refinement step on the Schur/Gram solve
  * rho / relax operating point

Emits one JSON line per (scene, config): raw @1cm/@1mm, polished rates,
throughput.
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import dataclasses
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
    from graphik_tpu.utils.environments import table_environment
    from graphik_tpu.graphs.problem import ProblemStructure

    B = int(_os.environ.get("SWEEP_B", "512"))

    scenes = {}
    scenes["ur10"] = library.load_ur10()[1]
    tpl = library.load_ur10()[0]
    scenes["ur10_table"] = ProblemStructure.from_template(
        tpl, obstacles=table_environment()
    )
    only = _os.environ.get("SWEEP_SCENES")
    if only:
        scenes = {k: scenes[k] for k in only.split(",")}

    base = CidgikParams(admm_iters=1000, admm_iters_rest=500,
                        max_outer=10, cone_ns_iters=16)
    grid = [
        ("base_1000x9x500_ns16", base),
        ("iters_2000x9x1000", dataclasses.replace(
            base, admm_iters=2000, admm_iters_rest=1000)),
        ("ns24", dataclasses.replace(base, cone_ns_iters=24)),
        ("ns32", dataclasses.replace(base, cone_ns_iters=32)),
        ("refine2", dataclasses.replace(base, refine_steps=2)),
        ("iters2x_ns24", dataclasses.replace(
            base, admm_iters=2000, admm_iters_rest=1000, cone_ns_iters=24)),
        ("rho0.5", dataclasses.replace(base, rho=0.5)),
        ("rho2.0", dataclasses.replace(base, rho=2.0)),
        ("relax1.0", dataclasses.replace(base, relax=1.0)),
        # round-2 grid: rho is the free lever (rho2.0 matched 2x iterations
        # at zero cost); find the rho plateau and the iters needed past it
        ("rho3.0", dataclasses.replace(base, rho=3.0)),
        ("rho4.0", dataclasses.replace(base, rho=4.0)),
        ("rho2_it1.5x", dataclasses.replace(
            base, rho=2.0, admm_iters=1500, admm_iters_rest=750)),
        ("rho2_it2x", dataclasses.replace(
            base, rho=2.0, admm_iters=2000, admm_iters_rest=1000)),
        ("rho3_it2x", dataclasses.replace(
            base, rho=3.0, admm_iters=2000, admm_iters_rest=1000)),
        ("rho2_relax1.8", dataclasses.replace(base, rho=2.0, relax=1.8)),
        ("rho2_it3x", dataclasses.replace(
            base, rho=2.0, admm_iters=3000, admm_iters_rest=1500)),
        # round-3 grid: the raw rate still rises at rho4 - find the knee
        ("rho5.0", dataclasses.replace(base, rho=5.0)),
        ("rho6.0", dataclasses.replace(base, rho=6.0)),
        ("rho8.0", dataclasses.replace(base, rho=8.0)),
        ("rho4_it2x", dataclasses.replace(
            base, rho=4.0, admm_iters=2000, admm_iters_rest=1000)),
        ("rho6_it2x", dataclasses.replace(
            base, rho=6.0, admm_iters=2000, admm_iters_rest=1000)),
        # round-4 grid: still rising at rho8
        ("rho10", dataclasses.replace(base, rho=10.0)),
        ("rho12", dataclasses.replace(base, rho=12.0)),
        ("rho16", dataclasses.replace(base, rho=16.0)),
        ("rho24", dataclasses.replace(base, rho=24.0)),
    ]
    sel = _os.environ.get("SWEEP_TAGS")
    if sel:
        keys = sel.split(",")
        grid = [g for g in grid if g[0] in keys]

    for scene, ps in scenes.items():
        comp = cd.compile_cidgik(ps)

        @jax.jit
        def gen(key):
            return api.random_goals(ps, key, (B,))[0]

        T_goal = gen(jax.random.PRNGKey(0))
        jax.block_until_ready(T_goal)

        for tag, cparams in grid:
            @jax.jit
            def stage_admm(Tg):
                out = cd.solve_cidgik(comp, Tg, params=cparams)
                return out["q"], out["feas"]

            @jax.jit
            def stage_finish(q0, Tg):
                with jax.default_matmul_precision("highest"):
                    e_pos0, e_rot0 = api.pose_error(ps, q0, Tg)
                    viol, ok = ps.check_distance_limits(ps.realization(q0))
                    q, e_pos, e_rot, viol, ok = api.polish_solution(
                        ps, q0, Tg, e_pos0, e_rot0, viol, ok
                    )
                    return e_pos0, e_rot0, e_pos, e_rot

            def run(Tg):
                q0, feas = stage_admm(Tg)
                return stage_finish(q0, Tg)

            t0 = time.perf_counter()
            out = run(T_goal)
            jax.block_until_ready(out)
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = run(T_goal)
            jax.block_until_ready(out)
            np.asarray(out[0])
            wall = time.perf_counter() - t0
            e0p, e0r, ep, er = (np.asarray(x) for x in out)
            raw_cm = (e0p < 1e-2) & (e0r < 1e-2)
            raw_mm = (e0p < 1e-3) & (e0r < np.deg2rad(1.0))
            pol_mm = (ep < 1e-3) & (er < np.deg2rad(1.0))
            print(json.dumps({
                "scene": scene, "tag": tag, "B": B,
                "solves_per_sec": round(B / wall, 1),
                "raw_1cm": round(float(raw_cm.mean()), 4),
                "raw_1mm": round(float(raw_mm.mean()), 4),
                "polished_1mm": round(float(pol_mm.mean()), 4),
                "median_raw_pos_err": round(float(np.median(e0p)), 6),
                "wall_s": round(wall, 2),
                "compile_s": round(compile_s, 1),
            }), flush=True)


if __name__ == "__main__":
    main()
