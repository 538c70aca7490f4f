"""Multi-host distributed entry point (SURVEY.md section 2.6 / section 5).

The reference is single-process (no NCCL/MPI/Gloo anywhere; SURVEY.md
section 5 "Distributed communication backend"); the scale axis here is the
instance batch sharded over every device of every host. This module owns
the process-level plumbing:

  * `initialize()` - `jax.distributed.initialize` wrapper with environment
    fallbacks (set by a cluster launcher or by the test harness).
  * `global_batch_mesh()` - 1-D mesh over ALL global devices; the batch
    axis spans NVLink within a host and the network across hosts.
  * `shard_local_batch()` - assemble a globally-sharded array from each
    process's local shard (hosts generate/load their own goals; no
    host-0 scatter bottleneck).
  * `solve_ik_global()` - sharded solve + global metric reduction; the
    embarrassingly parallel solve partitions with zero communication and
    the summary means become cross-host psums.

Single-process use degrades gracefully: every function works unchanged on
one process (mesh = local devices), so the same driver script runs from a
laptop CPU to a multi-host GPU cluster.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphik_tpu import api
from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.solvers.riemannian import TRParams


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Join the multi-process JAX runtime.

    Arguments default from the standard environment variables
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) so cluster
    launchers and the two-process CPU test configure workers by env alone.
    With one GPU per process, pass local_device_ids (or set
    CUDA_VISIBLE_DEVICES) so each process owns its own card.
    No-op when the distributed client is already initialized.
    """
    # Re-entry guard without reaching into jax._src internals: prefer the
    # public is_initialized() when this jax version has it, else fall back
    # to catching the "already initialized" RuntimeError below.
    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None and is_init():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as exc:  # already-initialized on older jax
        # jax has raised both "already initialized" and "distributed.initialize
        # should only be called once." across versions; treat either as the
        # documented no-op re-entry.
        msg = str(exc).lower()
        if (
            "already initialized" not in msg
            and "only be called once" not in msg
        ):
            raise


def global_batch_mesh(axis_name: str = "batch") -> Mesh:
    """1-D mesh over ALL global devices (every chip of every host)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def shard_local_batch(x_local, mesh: Mesh, axis_name: str = "batch"):
    """Assemble a globally-sharded array from per-process local shards.

    Each process passes its own slice of the global batch (equal sizes);
    the result is one global jax.Array whose leading axis is sharded over
    the mesh. Data never funnels through a single host.
    """
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(
            sharding, np.asarray(a)
        ),
        x_local,
    )


# Memoized jit(shard_map(...)) runners, keyed on (id(structure), mesh,
# params, ...). Keying on id() is safe from id-reuse collisions ONLY
# because each cached closure captures `structure` and keeps it alive for
# as long as its entry exists - an invariant the eviction below must
# preserve (evict the closure and the structure goes with it). The cache
# is bounded (FIFO, insertion order) so long-running multi-robot processes
# do not accumulate executables + structures without limit; 16 distinct
# (structure, mesh, params) combinations is far above any workload seen.
_RUNNER_CACHE = {}
_RUNNER_CACHE_MAX = 16


def solve_ik_global(
    structure: ProblemStructure,
    T_goal_local,
    mesh: Optional[Mesh] = None,
    params: TRParams = TRParams(),
    axis_name: str = "batch",
    criterion_pos: float = 1e-3,
    criterion_rot: float = float(np.pi / 180),
    **kwargs,
):
    """Solve the global goal batch; return (local result, global metrics).

    T_goal_local: this process's shard of the goal batch, (B_local, ...).
    The solve is data-parallel with zero communication; the metrics are
    computed inside the same jit so XLA lowers the means to cross-host
    collectives (psums) instead of host-side gathers.

    Returns
    -------
    out_local : dict of this process's addressable shards of the solution.
    metrics : dict of floats, identical on every process (global success
        rate at the BASELINE criterion, pose-only rate, mean iterations,
        global batch size).
    """
    if mesh is None:
        mesh = global_batch_mesh(axis_name)
    T_goal = shard_local_batch(jnp.asarray(T_goal_local), mesh, axis_name)

    # Memoize the jitted runner: rebuilding jit(shard_map(...)) per call
    # forces a retrace every solve, and in a multi-process runtime each
    # lowering adds a cross-host compile-coordination round trip - repeated
    # solves were paying seconds of overhead each (scaling_bench measured
    # 6x throughput loss at 2 processes before this cache).
    try:
        cache_key = (
            id(structure), mesh, axis_name, params,
            float(criterion_pos), float(criterion_rot),
            tuple(sorted(kwargs.items())),
        )
        hash(cache_key)
    except TypeError:
        cache_key = None

    def local(Tg):
        # Runs per device shard (shard_map): the Pallas solver kernel has no
        # SPMD partitioning rule, so shard_map - not sharding-annotated jit -
        # is what guarantees each device solves only its own shard. Metric
        # means become explicit psums over the batch axis.
        out = api.solve_ik(structure, Tg, params=params, **kwargs)
        hit = (
            (out["e_pos"] < criterion_pos)
            & (out["e_rot"] < criterion_rot)
            & out["success"]
        )
        pose_ok = (out["e_pos"] < criterion_pos) & (
            out["e_rot"] < criterion_rot
        )
        n = jax.lax.psum(
            jnp.asarray(hit.size, jnp.float32), axis_name
        )
        metrics = {
            "success_rate": jax.lax.psum(
                jnp.sum(hit.astype(jnp.float32)), axis_name) / n,
            "pose_only_rate": jax.lax.psum(
                jnp.sum(pose_ok.astype(jnp.float32)), axis_name) / n,
            "mean_iterations": jax.lax.psum(
                jnp.sum(out["iterations"].astype(jnp.float32)), axis_name
            ) / n,
            "mean_pos_err": jax.lax.psum(
                jnp.sum(out["e_pos"].astype(jnp.float32)), axis_name) / n,
        }
        return out, metrics

    run = _RUNNER_CACHE.get(cache_key) if cache_key is not None else None
    if run is None:
        run = jax.jit(jax.shard_map(
            local, mesh=mesh, in_specs=P(axis_name),
            out_specs=(P(axis_name), P()),
            check_vma=False,  # see mesh.solve_ik_sharded
        ))
        if cache_key is not None:
            while len(_RUNNER_CACHE) >= _RUNNER_CACHE_MAX:
                _RUNNER_CACHE.pop(next(iter(_RUNNER_CACHE)))
            _RUNNER_CACHE[cache_key] = run
    out, metrics = run(T_goal)
    # metrics are fully replicated scalars - addressable everywhere
    metrics = {k: float(v) for k, v in metrics.items()}
    metrics["global_batch"] = int(T_goal.shape[0])
    metrics["num_processes"] = jax.process_count()

    def local_shard(a):
        shards = [s.data for s in a.addressable_shards]
        return np.concatenate([np.asarray(s) for s in shards], axis=0) \
            if shards else np.asarray(a)

    out_local = {k: local_shard(v) for k, v in out.items()}
    return out_local, metrics
