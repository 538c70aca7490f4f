"""Multi-host worker / demo driver for parallel/distributed.py.

Run one copy per process (a cluster launcher does this;
tests/test_distributed.py spawns two over 127.0.0.1). Env contract:

  JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
      standard jax.distributed configuration; leave unset to run
      single-process (the same code path, 1-process mesh).
  GRAPHIK_GOALS   global goal batch size (default 8)
  GRAPHIK_OUT     path to write this process's JSON summary
  GRAPHIK_SCALING_REPS
      when set (>0): after a warmup solve, time that many repeated global
      solves and report global solves/s (the scaling-efficiency probe -
      the in-solve psum collectives synchronize the processes, so every
      process measures the same global wall)

Each process generates ITS OWN shard of the seeded global goal batch
(deterministic: the full batch is derived from one key and sliced by
process index - no host-0 scatter), solves over the global mesh, and
writes {world, metrics} to GRAPHIK_OUT.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS", "cpu"))
from graphik_tpu.utils.cache import enable_persistent_cache

enable_persistent_cache()

import numpy as np
import jax.numpy as jnp


def main():
    from graphik_tpu import api
    from graphik_tpu.parallel import distributed
    from graphik_tpu.robots import library
    from graphik_tpu.solvers.riemannian import TRParams

    if "JAX_COORDINATOR_ADDRESS" in os.environ:
        distributed.initialize()

    goals = int(os.environ.get("GRAPHIK_GOALS", "8"))
    out_path = os.environ.get("GRAPHIK_OUT", "/tmp/graphik_dist_out.json")

    tpl, ps = library.load_planar_chain(6, limits=np.pi / 2)

    # deterministic global batch, sliced per process (no host-0 scatter)
    T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(42), (goals,))
    n_proc = jax.process_count()
    pid = jax.process_index()
    per = goals // n_proc
    T_local = np.asarray(T_goal)[pid * per:(pid + 1) * per]

    mesh = distributed.global_batch_mesh()
    # The XLA edge backend runs on any platform (the fused kernel is
    # GPU-only, and these workers default to the CPU).
    params = TRParams(maxiter=60, backend="edge")
    out_local, metrics = distributed.solve_ik_global(
        ps, T_local, mesh=mesh, params=params,
    )

    record = {
        "world": jax.device_count(),
        "process": pid,
        "local_batch": int(out_local["q"].shape[0]),
        "metrics": metrics,
    }

    reps = int(os.environ.get("GRAPHIK_SCALING_REPS", "0"))
    if reps:
        import time

        t0 = time.perf_counter()
        for _ in range(reps):
            out_local, metrics = distributed.solve_ik_global(
                ps, T_local, mesh=mesh, params=params,
            )
        jax.block_until_ready(out_local["q"])
        wall = time.perf_counter() - t0
        record["scaling"] = {
            "reps": reps,
            "wall_s": wall,
            "global_solves_per_s": goals * reps / wall,
        }

    with open(out_path, "w") as f:
        json.dump(record, f)
    print(f"[worker {pid}] metrics {metrics}", flush=True)


if __name__ == "__main__":
    main()
