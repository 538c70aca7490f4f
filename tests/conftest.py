"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

The suite runs on the CPU by default (multi-device sharding is validated on
a virtual mesh per SURVEY.md section 4); float64 is enabled so numerical
parity with the reference's float64 semantics can be asserted tightly.
float32 behaviour is covered by dedicated dtype tests, and the fused
Pallas kernel runs here in interpret mode (`interpret_kernel` fixture).

Tests that need the GPU carry the `gpu` marker and skip elsewhere; run them
on a machine with a card with

    GRAPHIK_TEST_PLATFORM=cuda python -m pytest -m gpu -n 0 tests/
"""

import os

_PLATFORM = os.environ.get("GRAPHIK_TEST_PLATFORM", "cpu")
os.environ["JAX_PLATFORMS"] = _PLATFORM
if _PLATFORM == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import sys
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import pytest

# config.update also takes effect when jax was imported before this file.
jax.config.update("jax_platforms", _PLATFORM)
jax.config.update("jax_enable_x64", True)
# The persistent compilation cache is DISABLED for the test process:
# XLA:CPU's executable serialize()/deserialize() has segfaulted after ~100+
# accumulated compilations in one process on some jaxlib/host combinations.
# The in-memory jit cache still covers repeated shapes within the run.
jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    """`gpu`-marked tests run only where JAX's default backend is the GPU
    (decided per test, never at import, so every xdist worker collects the
    same tests)."""
    if request.node.get_closest_marker("gpu") and (
        jax.default_backend() != "gpu"
    ):
        pytest.skip("needs an NVIDIA GPU (GRAPHIK_TEST_PLATFORM=cuda)")


@pytest.fixture
def interpret_kernel(monkeypatch):
    """Run the fused TR kernel in the Pallas interpreter wherever the solver
    stack calls it (this CPU suite has no GPU to compile it for)."""
    from graphik_tpu.ops import tr_pallas

    monkeypatch.setattr(
        tr_pallas, "solve_tr_pallas",
        partial(tr_pallas.solve_tr_pallas, interpret=True),
    )
