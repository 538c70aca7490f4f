"""Fleet-layer tests on the 8-device virtual CPU mesh (parallel/mesh.py).

conftest forces JAX_PLATFORMS=cpu with xla_force_host_platform_device_count=8,
so every test here exercises real GSPMD partitioning + collectives
(SURVEY.md section 4: multi-host tests runnable on CPU).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphik_tpu import api
from graphik_tpu.parallel import mesh as fleet
from graphik_tpu.robots.library import load_ur10
from graphik_tpu.solvers.riemannian import TRParams


@pytest.fixture(scope="module")
def ur10():
    return load_ur10()[1]


@pytest.fixture(scope="module")
def goals(ur10):
    T_goal, q_goal = api.random_goals(ur10, jax.random.PRNGKey(5), (16,))
    return jnp.asarray(T_goal), q_goal


def test_virtual_mesh_has_8_devices():
    assert jax.device_count() == 8


def test_sharded_solve_matches_unsharded(ur10, goals):
    """Sharding the batch over the mesh must not change results: the solve
    is data-parallel with no cross-instance math."""
    T_goal, _ = goals
    params = TRParams(maxiter=25)
    m = fleet.make_mesh()
    out_sharded = fleet.solve_ik_sharded(ur10, T_goal, m, params=params)
    out_local = api.solve_ik(ur10, T_goal, params=params)
    # GSPMD partitioning reorders reductions (eigh init, inner products), so
    # f64 trajectories diverge at rounding scale; solutions must agree to
    # well below the 1 mm success criterion, and flags must match.
    np.testing.assert_allclose(
        np.asarray(out_sharded["q"]), np.asarray(out_local["q"]),
        rtol=1e-3, atol=1e-4,
    )
    np.testing.assert_array_equal(
        np.asarray(out_sharded["success"]), np.asarray(out_local["success"])
    )


def test_sharded_solve_output_is_sharded(ur10, goals):
    T_goal, _ = goals
    m = fleet.make_mesh()
    out = fleet.solve_ik_sharded(ur10, T_goal, m, params=TRParams(maxiter=5))
    shard_devs = {s.device for s in out["q"].addressable_shards}
    assert len(shard_devs) == 8


def test_sharded_pallas_f32_path(ur10, goals, interpret_kernel):
    """The fused-kernel (interpret) path runs under shard_map: one kernel
    call per device shard, the structure the multi-GPU path lowers to."""
    T_goal, _ = goals
    m = fleet.make_mesh()
    out = fleet.solve_ik_sharded(
        ur10, T_goal, m,
        params=TRParams(maxiter=5, backend="pallas"),
        dtype=jnp.float32,
    )
    assert out["q"].shape == (16, 6)
    assert np.isfinite(np.asarray(out["e_pos"])).all()


def test_sharded_runner_is_built_once(ur10, goals):
    """Repeated sharded solves with the same arguments reuse one jitted
    program instead of recompiling every call."""
    T_goal, _ = goals
    m = fleet.make_mesh()
    params = TRParams(maxiter=3)
    fleet.solve_ik_sharded(ur10, T_goal, m, params=params)
    n = len(fleet._SHARDED_RUNNERS)
    key = next(k for k, v in fleet._SHARDED_RUNNERS.items()
               if v[0] is ur10 and k[2] == params)
    fn = fleet._SHARDED_RUNNERS[key][1]
    fleet.solve_ik_sharded(ur10, T_goal, m, params=params)
    assert len(fleet._SHARDED_RUNNERS) == n
    assert fleet._SHARDED_RUNNERS[key][1] is fn


def test_restarts_never_worse_than_single(ur10, goals):
    """Restart 0 reproduces the deterministic init, so best-of-restarts
    can only improve the per-goal selection score."""
    T_goal, _ = goals
    params = TRParams(maxiter=60)
    single = api.solve_ik(ur10, T_goal, params=params)
    multi = fleet.solve_ik_restarts(
        ur10, T_goal, jax.random.PRNGKey(0), n_restarts=3, params=params
    )
    big = 1e6

    def score(out):
        return (
            np.asarray(out["e_pos"])
            + np.asarray(out["e_rot"])
            + np.where(np.asarray(out["success"]), 0.0, big)
        )

    assert np.all(score(multi) <= score(single) + 1e-9)
    ri = np.asarray(multi["restart_index"])
    assert ri.shape == (16,)
    assert ri.min() >= 0 and ri.max() < 3


def test_restarts_selection_consistency(ur10, goals):
    """The returned per-goal fields must all come from the SAME restart:
    recomputing pose error from the returned q matches e_pos/e_rot."""
    T_goal, _ = goals
    multi = fleet.solve_ik_restarts(
        ur10, T_goal, jax.random.PRNGKey(0), n_restarts=2,
        params=TRParams(maxiter=30),
    )
    e_pos, e_rot = api.pose_error(ur10, multi["q"], T_goal)
    np.testing.assert_allclose(
        np.asarray(e_pos), np.asarray(multi["e_pos"]), rtol=1e-6, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(e_rot), np.asarray(multi["e_rot"]), rtol=1e-6, atol=1e-9
    )


def test_summarize_reduces_correctly():
    """summarize() on a hand-built result dict gives exact rates."""
    out = {
        "e_pos": jnp.asarray([1e-5, 1e-5, 5e-3, 1e-5]),
        "e_rot": jnp.asarray([1e-4, 1e-4, 1e-4, 5e-1]),
        "success": jnp.asarray([True, False, True, True]),
        "iterations": jnp.asarray([10, 20, 30, 40]),
    }
    s = fleet.summarize(out)
    # hit = pos<1e-3 & rot<pi/180 & success -> only instance 0
    assert float(s["success_rate"]) == pytest.approx(0.25)
    assert float(s["pose_only_rate"]) == pytest.approx(0.5)
    assert float(s["mean_iterations"]) == pytest.approx(25.0)


def test_summarize_cross_device(ur10, goals):
    """summarize over a mesh-sharded batch reduces across devices to the
    same values as the single-device reduction of identical data."""
    T_goal, _ = goals
    m = fleet.make_mesh()
    from jax.sharding import NamedSharding, PartitionSpec as P

    out = api.solve_ik(ur10, T_goal, params=TRParams(maxiter=10))
    keys = ("e_pos", "e_rot", "success", "iterations")
    data = {k: out[k] for k in keys}
    s_local = {k: float(v) for k, v in fleet.summarize(data).items()}

    sharding = NamedSharding(m, P("batch"))
    data_sharded = jax.device_put(data, sharding)
    fn = jax.jit(fleet.summarize, in_shardings=(sharding,), out_shardings=None)
    s_sharded = fn(data_sharded)
    for k in s_local:
        np.testing.assert_allclose(float(s_sharded[k]), s_local[k], rtol=1e-9)
