"""Batch-size scaling profile of the raw TR solve on the live device.

Answers: is the solver loop overhead-bound (throughput grows ~linearly with
batch) or bandwidth/compute-bound (flat)? Sweeps batch at fixed maxiter.

Usage: python tools/profile_batch.py [maxiter] [backend]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from graphik_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from graphik_tpu import api
    from graphik_tpu.robots.library import load_ur10
    from graphik_tpu.solvers import riemannian
    from graphik_tpu.solvers.riemannian import TRParams

    maxiter = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    backend = sys.argv[2] if len(sys.argv) > 2 else "dense"
    tpl, ps = load_ur10()
    omega, psi_L, psi_U = ps.masks()
    p = TRParams(maxiter=maxiter, backend=backend)

    def sync(tree):
        jax.block_until_ready(tree)
        np.asarray(jax.tree_util.tree_leaves(tree)[0])

    for batch in (1024, 4096, 8192, 16384):
        key = jax.random.PRNGKey(0)
        T_goal, _ = api.random_goals(ps, key, (batch,))
        inst = ps.instance(jnp.asarray(T_goal), smooth=True)
        Y0 = riemannian.generate_initialization(
            inst["lb"], inst["ub"], jnp.asarray(omega), ps.dim
        )
        Y0 = jax.block_until_ready(Y0)
        D_goal = jax.block_until_ready(inst["D_goal"])

        fn = jax.jit(
            lambda Y0, Dg: riemannian.solve(Y0, Dg, omega, psi_L, psi_U, params=p)
        )
        t0 = time.perf_counter()
        out = fn(Y0, D_goal)
        sync(out)
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fn(Y0, D_goal)
        sync(out)
        t_run = time.perf_counter() - t0
        iters = np.asarray(out["iterations"])
        gn = np.asarray(out["gradnorm"])
        print(
            f"backend={backend} batch={batch:6d} maxiter={maxiter}: "
            f"compile={t_compile:.1f}s run={t_run*1e3:8.0f}ms "
            f"throughput={batch/t_run:8.0f}/s iters mean={iters.mean():.0f} "
            f"max={iters.max()} conv={(gn < 2e-6).mean():.2f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
