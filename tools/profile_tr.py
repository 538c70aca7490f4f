"""Profile the TR solver hot path on the available accelerator.

Measures, for the UR10 Riemannian solve:
  * compile time of the raw riemannian.solve (no polish / joint recovery)
  * wall time vs maxiter (isolating per-outer-iteration cost)
  * mean inner (tCG) iterations per outer iteration
  * effect of maxinner cap

Usage: python tools/profile_tr.py [batch]
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

    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    tpl, ps = load_ur10()

    key = jax.random.PRNGKey(0)
    T_goal, _ = api.random_goals(ps, key, (batch,))

    # Build the instance data once (host side)
    inst = ps.instance(T_goal, smooth=True)
    omega, psi_L, psi_U = ps.masks()
    Y0 = riemannian.generate_initialization(
        inst["lb"], inst["ub"], jnp.asarray(omega), ps.dim
    )
    Y0 = jax.block_until_ready(Y0)
    D_goal = jax.block_until_ready(inst["D_goal"])
    print(f"N={Y0.shape[-2]} d={Y0.shape[-1]} batch={batch}", flush=True)

    def sync(tree):
        jax.block_until_ready(tree)
        np.asarray(jax.tree_util.tree_leaves(tree)[0])

    for maxinner in (None, 16, 8):
        for maxiter in (50, 100, 200):
            p = TRParams(maxiter=maxiter, maxinner=maxinner)
            fn = jax.jit(
                lambda Y0, Dg, p=p: riemannian.solve(
                    Y0, Dg, omega, psi_L, psi_U, params=p
                )
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
            inner = np.asarray(out["num_inner"])
            gn = np.asarray(out["gradnorm"])
            print(
                f"maxinner={maxinner} maxiter={maxiter}: compile={t_compile:.1f}s "
                f"run={t_run*1e3:.0f}ms  iters mean={iters.mean():.0f} max={iters.max()} "
                f"inner/outer={inner.sum()/max(iters.sum(),1):.1f} "
                f"conv={(gn < 2e-6).mean():.2f} "
                f"us/outer-iter={(t_run/iters.max())*1e6:.0f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
