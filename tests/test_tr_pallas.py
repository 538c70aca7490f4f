"""Parity tests for the fused Pallas TR solver (ops/tr_pallas.py).

The kernel is written for the Triton route. Here it runs in the Pallas
interpreter on the CPU, and its lowering to Triton IR for CUDA is checked
without a GPU; the `gpu`-marked tests run the compiled kernel on the card.
Oracle: the dense XLA TR solver (solvers/riemannian.py), itself
property-tested against the reference semantics.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphik_tpu import api
from graphik_tpu.ops import edge as edge_ops
from graphik_tpu.ops import tr_pallas
from graphik_tpu.ops.tr_pallas import solve_tr_pallas
from graphik_tpu.robots.library import load_planar_chain, load_ur10
from graphik_tpu.solvers import riemannian
from graphik_tpu.solvers.costs import make_masks
from graphik_tpu.solvers.riemannian import TRParams


@pytest.fixture(scope="module")
def ur10_problem():
    tpl, ps = load_ur10()
    omega, psi_L, psi_U = ps.masks()
    B = 8
    T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(3), (B,))
    inst = ps.instance(jnp.asarray(T_goal), smooth=True, dtype=jnp.float32)
    Y0 = riemannian.generate_initialization(
        inst["lb"], inst["ub"], jnp.asarray(omega, jnp.float32), ps.dim
    ).astype(jnp.float32)
    D_goal = inst["D_goal"].astype(jnp.float32)
    L_mask, U_mask = make_masks(
        jnp.asarray(omega, jnp.float32),
        jnp.asarray(psi_L, jnp.float32),
        jnp.asarray(psi_U, jnp.float32),
    )
    ep = edge_ops.build_edge_problem(
        omega, psi_L, psi_U,
        np.asarray(L_mask, np.float64), np.asarray(U_mask, np.float64),
        dim=ps.dim,
    )
    return ps, omega, psi_L, psi_U, ep, Y0, D_goal


def _dense_solve(omega, psi_L, psi_U, Y0, D_goal, maxiter):
    return riemannian.solve(
        Y0, D_goal,
        omega.astype(np.float32),
        psi_L.astype(np.float32),
        psi_U.astype(np.float32),
        params=TRParams(maxiter=maxiter, backend="dense"),
    )


def test_one_step_parity(ur10_problem):
    """After a single TR step the kernel matches the XLA path near-exactly."""
    ps, omega, psi_L, psi_U, ep, Y0, D_goal = ur10_problem
    ref = _dense_solve(omega, psi_L, psi_U, Y0, D_goal, maxiter=1)
    out = solve_tr_pallas(
        ep, Y0, ep.edge_values(D_goal), maxiter=1, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(out["cost"]), np.asarray(ref["cost"]), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(out["num_inner"]), np.asarray(ref["num_inner"])
    )
    np.testing.assert_allclose(
        np.asarray(out["Y"]), np.asarray(ref["Y"]), rtol=1e-4, atol=1e-5
    )


def test_multi_step_convergence_parity(ur10_problem):
    """Both solvers reach comparable cost after the same iteration budget.

    Trajectories diverge in f32 (different accumulation orders), so assert
    convergence quality, not bitwise equality.
    """
    ps, omega, psi_L, psi_U, ep, Y0, D_goal = ur10_problem
    ref = _dense_solve(omega, psi_L, psi_U, Y0, D_goal, maxiter=40)
    out = solve_tr_pallas(
        ep, Y0, ep.edge_values(D_goal), maxiter=40, interpret=True
    )
    ref_cost = np.asarray(ref["cost"])
    pal_cost = np.asarray(out["cost"])
    # Within 100x of each other per instance at the deep-convergence tail,
    # and the same order of magnitude in the median.
    assert np.median(pal_cost) < 10 * max(np.median(ref_cost), 1e-8)
    assert np.all(pal_cost < 1e-2)


def test_batch_padding_independence(ur10_problem):
    """Instances are independent: a 3-instance batch (padded to one block)
    matches the first 3 instances of the 8-instance batch."""
    ps, omega, psi_L, psi_U, ep, Y0, D_goal = ur10_problem
    dg = ep.edge_values(D_goal)
    full = solve_tr_pallas(ep, Y0, dg, maxiter=5, interpret=True)
    sub = solve_tr_pallas(ep, Y0[:3], dg[:3], maxiter=5, interpret=True)
    np.testing.assert_allclose(
        np.asarray(sub["Y"]), np.asarray(full["Y"])[:3], rtol=1e-6, atol=1e-7
    )
    np.testing.assert_array_equal(
        np.asarray(sub["iterations"]), np.asarray(full["iterations"])[:3]
    )


def test_solve_dispatch_f64_falls_back_to_dense(ur10_problem):
    """float64 inputs resolve to the dense XLA path by default and keep
    their dtype; asking for the float32-only kernel with them raises."""
    ps, omega, psi_L, psi_U, ep, Y0, D_goal = ur10_problem
    out = riemannian.solve(
        Y0.astype(jnp.float64),
        D_goal.astype(jnp.float64),
        omega, psi_L, psi_U,
        params=TRParams(maxiter=3),
    )
    assert out["Y"].dtype == jnp.float64
    with pytest.raises(ValueError, match="float32 only"):
        riemannian.solve(
            Y0.astype(jnp.float64), D_goal.astype(jnp.float64),
            omega, psi_L, psi_U,
            params=TRParams(maxiter=3, backend="pallas"),
        )


def test_solve_dispatch_f32_uses_kernel(ur10_problem, interpret_kernel):
    """float32 inputs resolve to the kernel by default, and the solver's
    call matches a direct kernel call."""
    ps, omega, psi_L, psi_U, ep, Y0, D_goal = ur10_problem
    via_solve = riemannian.solve(
        Y0, D_goal, omega, psi_L, psi_U, params=TRParams(maxiter=3),
    )
    direct = solve_tr_pallas(
        ep, Y0, ep.edge_values(D_goal), maxiter=3, interpret=True
    )
    np.testing.assert_allclose(
        np.asarray(via_solve["Y"]), np.asarray(direct["Y"]),
        rtol=1e-6, atol=1e-7,
    )


def test_limit_hinges_active_planar():
    """The kernel handles bound (hinge) edges: a planar chain with tight
    joint limits produces bounded edges, and solutions respect them."""
    tpl, ps = load_planar_chain(6, limits=np.pi / 3)
    omega, psi_L, psi_U = ps.masks()
    assert (psi_L > 0).any() or (psi_U > 0).any()
    B = 8
    T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(11), (B,))
    inst = ps.instance(jnp.asarray(T_goal), smooth=True, dtype=jnp.float32)
    Y0 = riemannian.generate_initialization(
        inst["lb"], inst["ub"], jnp.asarray(omega, jnp.float32), ps.dim
    ).astype(jnp.float32)
    D_goal = inst["D_goal"].astype(jnp.float32)
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
    ref = _dense_solve(omega, psi_L, psi_U, Y0, D_goal, maxiter=30)
    out = solve_tr_pallas(
        ep, Y0, ep.edge_values(D_goal), maxiter=30, interpret=True
    )
    assert float(np.median(np.asarray(out["cost"]))) < 10 * max(
        float(np.median(np.asarray(ref["cost"]))), 1e-7
    )


@pytest.mark.parametrize(
    "n, expect", [(1, 16), (9, 16), (16, 16), (17, 32), (64, 64), (76, 128)]
)
def test_pow2_padding(n, expect):
    """Every padded kernel dimension is a power of two >= 16 (Triton block
    shapes; tl.dot operands)."""
    assert tr_pallas._pow2(n) == expect


@pytest.mark.parametrize(
    "B, Np, Ep, d, anchors, tile, warps",
    [
        (8192, 16, 64, 3, False, 32, 8),    # ur10: the measured best block
        (2048, 16, 64, 3, False, 16, 4),    # 2048 / 32 < 132 SMs: 16 on 4 warps
        (8, 16, 64, 3, False, 16, 4),       # tiny batch: the minimum block
        (8192, 16, 64, 3, True, 32, 8),     # ur10_table: anchor planes fit
        (32768, 16, 64, 3, False, 32, 8),   # no block beyond 32 instances
        (8192, 32, 128, 3, False, 32, 16),  # kuka widths (N=18, E=76)
        (8192, 16, 32, 2, False, 32, 4),    # planar6 widths: at least 4 warps
    ],
)
def test_block_rule(B, Np, Ep, d, anchors, tile, warps):
    """The block rule: <= ~160 registers of state per thread (the H100
    sweep spilled at ~264 and ran 2-3x slower), >= 132 blocks, <= 32
    instances per block."""
    assert tr_pallas._choose_block(B, Np, Ep, d, anchors) == (tile, warps)


def test_kernel_padding_shapes(ur10_problem):
    """A planar chain (N=9, E=21) and a batch that is no multiple of the
    block pad to the kernel's shapes and unpad back to the caller's."""
    tpl, ps = load_planar_chain(6, limits=np.pi / 3)
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
    assert (ps.N, ep.E) == (9, 21)
    B = 5
    Y0 = jnp.asarray(np.random.RandomState(0).randn(B, ps.N, 2), jnp.float32)
    dg = jnp.ones((B, ep.E), jnp.float32)
    out = solve_tr_pallas(ep, Y0, dg, maxiter=2, interpret=True)
    assert out["Y"].shape == (B, ps.N, 2)
    assert out["Y"].dtype == jnp.float32
    for k in ("cost", "gradnorm", "iterations", "num_inner"):
        assert out[k].shape == (B,), k
    assert np.isfinite(np.asarray(out["Y"])).all()


def test_kernel_refuses_cpu_without_interpret(ur10_problem):
    """Without interpret=True the kernel compiles for the GPU only."""
    ps, omega, psi_L, psi_U, ep, Y0, D_goal = ur10_problem
    with pytest.raises(ValueError, match="GPU"):
        solve_tr_pallas(ep, Y0, ep.edge_values(D_goal), maxiter=1)


def test_bad_tile_rejected(ur10_problem):
    ps, omega, psi_L, psi_U, ep, Y0, D_goal = ur10_problem
    with pytest.raises(ValueError, match="power of two"):
        solve_tr_pallas(ep, Y0, ep.edge_values(D_goal), maxiter=1,
                        tile=24, interpret=True)


def _lower_for_cuda(monkeypatch, ep, B, N, d, **kw):
    """Lower the compiled (not interpreted) kernel to Triton IR for CUDA.

    The lowering runs on any host; only compiling the IR needs the card."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    fn = jax.jit(lambda Y, dg: solve_tr_pallas(ep, Y, dg, **kw))
    lowered = fn.trace(
        jax.ShapeDtypeStruct((B, N, d), jnp.float32),
        jax.ShapeDtypeStruct((B, ep.E), jnp.float32),
    ).lower(lowering_platforms=("cuda",))
    return lowered.as_text()


@pytest.mark.parametrize("robot", ["ur10", "planar6"])
def test_lowers_to_triton_for_cuda(robot, monkeypatch):
    """The production call lowers through the Triton route at full width
    (no value slices, no general concatenate, dot operands >= 16)."""
    if robot == "ur10":
        ps = load_ur10()[1]
    else:
        ps = load_planar_chain(6, limits=np.pi / 2)[1]
    omega, psi_L, psi_U = ps.masks()
    ep = edge_ops.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
    text = _lower_for_cuda(
        monkeypatch, ep, 8192, ps.N, ps.dim,
        maxiter=100, maxinner=24, plateau_every=16, plateau_rtol=1e-4,
        res_tol=1e-3,
    )
    assert "__gpu$xla.gpu.triton" in text
    assert text.count("__gpu$xla.gpu.triton") == 1


def test_lowers_to_triton_for_cuda_anchored(monkeypatch):
    """The anchored-obstacle kernel (streamed anchor chunks) lowers too."""
    from graphik_tpu.graphs.problem import ProblemStructure
    from graphik_tpu.utils.environments import table_environment

    scene = ProblemStructure.from_template(
        load_ur10()[0], obstacles=table_environment()
    )
    spec = scene.reduced_spec()
    Nr = spec["Nr"]
    omega, psi_L, psi_U = scene.masks()
    ep = edge_ops.build_edge_problem(
        omega[:Nr, :Nr], psi_L[:Nr, :Nr], psi_U[:Nr, :Nr], dim=3,
        anchors=spec,
    )
    text = _lower_for_cuda(monkeypatch, ep, 8192, Nr, 3,
                           maxiter=250, maxinner=32, plateau_every=16)
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
def test_compiled_kernel_one_step_parity_gpu(ur10_problem):
    """On the card: the compiled kernel matches the dense f32 path after
    one TR step (the interpret-mode check, run compiled)."""
    ps, omega, psi_L, psi_U, ep, Y0, D_goal = ur10_problem
    with jax.default_matmul_precision("highest"):
        ref = _dense_solve(omega, psi_L, psi_U, Y0, D_goal, maxiter=1)
    out = solve_tr_pallas(ep, Y0, ep.edge_values(D_goal), maxiter=1)
    np.testing.assert_allclose(
        np.asarray(out["cost"]), np.asarray(ref["cost"]), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(out["num_inner"]), np.asarray(ref["num_inner"])
    )


@pytest.mark.gpu
def test_make_solver_kernel_matches_dense_gpu():
    """On the card: make_solver with the compiled kernel (the float32
    default) solves as many goals as the dense XLA backend."""
    ps = load_ur10()[1]
    T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(5), (256,))
    T_goal = jnp.asarray(T_goal, jnp.float32)
    rates = {}
    for backend in (None, "dense"):
        solver = api.make_solver(
            ps, params=TRParams.production(maxiter=100, maxinner=24,
                                           backend=backend),
        )
        out = solver(T_goal)
        ok = (np.asarray(out["success"]) & (np.asarray(out["e_pos"]) < 1e-3)
              & (np.asarray(out["e_rot"]) < np.pi / 180))
        rates[backend] = ok.mean()
    assert rates[None] >= 0.8
    assert abs(rates[None] - rates["dense"]) <= 0.05
