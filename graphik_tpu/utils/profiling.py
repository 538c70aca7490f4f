"""Stage timing and profiler hooks (SURVEY.md section 5, tracing/profiling).

The reference records per-solve wall time in pymanopt's optlog
(reference trust_region.py:177,433 -> riemannian_solver.py:212-215) and SDP
solver_stats (convex_iteration.py:236-242). The equivalent here:

* `StageTimer` - named wall-clock stages with counts/totals; device work is
  fenced (block_until_ready plus a pull of one result) so JAX's async
  dispatch cannot under-report.
* `timed(name)` - context manager sugar on a shared timer.
* `device_trace(dir)` - jax.profiler trace scope (TensorBoard/Perfetto);
  raises if the profiler cannot start.
* `require_gpu()` / `gpu_card()` - what every GPU measurement names: the
  devices JAX runs on (refusing anything but GPUs) and the card's name
  and power limit as nvidia-smi reports them.

These are host-side tools: nothing here runs inside jit, so hot paths are
unaffected unless a timer is explicitly used.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Dict, Optional

import numpy as np


def fence(tree) -> None:
    """Block until `tree`'s device computations are done and one leaf
    has reached the host (the result a caller would read)."""
    import jax

    jax.block_until_ready(tree)
    leaves = jax.tree_util.tree_leaves(tree)
    if leaves:
        np.asarray(leaves[0])


@dataclasses.dataclass
class StageRecord:
    total_s: float = 0.0
    count: int = 0
    last_s: float = 0.0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class StageTimer:
    """Accumulates wall time per named stage.

    Example:
        timer = StageTimer()
        with timer.stage("solve"):
            out = solver(T_goal)
            timer.sync(out)          # fence device work into the stage
        print(timer.summary())
    """

    def __init__(self) -> None:
        self.records: Dict[str, StageRecord] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_result=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if sync_result is not None:
                fence(sync_result)
            dt = time.perf_counter() - t0
            rec = self.records.setdefault(name, StageRecord())
            rec.total_s += dt
            rec.count += 1
            rec.last_s = dt

    def sync(self, tree) -> None:
        fence(tree)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(r.total_s, 6),
                "count": r.count,
                "mean_s": round(r.mean_s, 6),
                "last_s": round(r.last_s, 6),
            }
            for k, r in self.records.items()
        }

    def reset(self) -> None:
        self.records.clear()


_GLOBAL = StageTimer()


def timed(name: str, sync_result=None):
    """Context manager recording into the module-global timer."""
    return _GLOBAL.stage(name, sync_result=sync_result)


def global_summary() -> Dict[str, Dict[str, float]]:
    return _GLOBAL.summary()


def reset() -> None:
    _GLOBAL.reset()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """jax.profiler trace scope; no-op only when log_dir is None.

    View with TensorBoard's profile plugin or Perfetto. A profiler that
    fails to start raises: a trace that silently records nothing would be
    read as an idle device.
    """
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def require_gpu():
    """The devices JAX found; exits non-zero unless they are GPUs (a
    measurement that finds no GPU must not fall back to the CPU)."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU, JAX found {devices[0].platform!r}"
        )
    return devices


def gpu_card() -> str:
    """`name, power.limit` of the first card, from nvidia-smi (a subprocess
    that stays off JAX). A card below its top power limit runs slower
    under load, so every time measured on it is reported beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]
