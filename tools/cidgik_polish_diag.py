"""Why does GN polish stall on CIDGIK output? Budget vs basin."""
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
    from graphik_tpu.solvers import local as local_solver
    from graphik_tpu.solvers.cidgik import CidgikParams
    from graphik_tpu.solvers.local import LocalParams

    B = 128
    ps = library.load_ur10()[1]
    comp = cd.compile_cidgik(ps)
    key = jax.random.PRNGKey(0)
    T_goal, _ = api.random_goals(ps, key, (B,))
    T_goal = jnp.asarray(T_goal)

    cparams = CidgikParams(admm_iters=800, max_outer=8)
    out = jax.jit(lambda Tg: cd.solve_cidgik(comp, Tg, params=cparams))(T_goal)
    q0 = out["q"]
    e0 = api.pose_error(ps, q0, T_goal)
    np_e0 = np.asarray(e0[0])
    print(json.dumps({"tag": "raw", "median_pos": float(np.median(np_e0)),
                      "p90_pos": float(np.percentile(np_e0, 90)),
                      "hit_1cm": float((np_e0 < 1e-2).mean())}), flush=True)

    def report(tag, q):
        ep, er = api.pose_error(ps, q, T_goal)
        ep, er = np.asarray(ep), np.asarray(er)
        print(json.dumps({
            "tag": tag,
            "median_pos": float(np.median(ep)),
            "median_rot": float(np.median(er)),
            "hit_1cm": float(((ep < 1e-2) & (er < 1e-2)).mean()),
            "hit_1mm": float(((ep < 1e-3) & (er < np.deg2rad(1))).mean()),
        }), flush=True)

    for it in (30, 100, 300):
        pol = jax.jit(lambda q: local_solver.solve_local(
            ps, T_goal, q, LocalParams(maxiter=it, tol_grad=1e-8)))(q0)
        report(f"lm{it}", pol["q"])

    # restarted polish: q0 plus noise, keep the best of 4
    kk = jax.random.PRNGKey(5)
    qs = [q0] + [
        q0 + 0.2 * jax.random.normal(jax.random.fold_in(kk, i), q0.shape)
        for i in range(3)
    ]

    def best_of(qcands):
        best_q, best_s = None, None
        for qc in qcands:
            pol = jax.jit(lambda q: local_solver.solve_local(
                ps, T_goal, q, LocalParams(maxiter=100, tol_grad=1e-8)))(qc)
            ep, er = api.pose_error(ps, pol["q"], T_goal)
            s = ep + er
            if best_q is None:
                best_q, best_s = pol["q"], s
            else:
                take = s < best_s
                best_q = jnp.where(take[..., None], pol["q"], best_q)
                best_s = jnp.where(take, s, best_s)
        return best_q

    report("lm100_restart4", best_of(qs))


if __name__ == "__main__":
    main()
