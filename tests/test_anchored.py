"""Anchored-obstacle reduction tests (problem.reduced_spec + backends).

The reduction turns obstacle NODES (reference graph_base.py:182-211) into
hinge terms against constant points. Oracles: the full-node dense
formulation, cross-backend parity, and autodiff.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphik_tpu import api
from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.ops import edge as edge_ops
from graphik_tpu.robots.library import load_ur10
from graphik_tpu.solvers import costs
from graphik_tpu.solvers.riemannian import TRParams, manifold_proj


@pytest.fixture(scope="module")
def scene():
    """UR10 plus 3 spherical obstacles near the workspace."""
    tpl, ps0 = load_ur10()
    obstacles = [
        (np.array([0.5, 0.5, 0.5]), 0.25),
        (np.array([-0.5, 0.4, 0.8]), 0.2),
        (np.array([0.2, -0.6, 0.3]), 0.3),
    ]
    ps = ProblemStructure.from_template(tpl, obstacles=obstacles)
    return ps


def test_reduced_spec_shape(scene):
    spec = scene.reduced_spec()
    assert spec is not None
    assert spec["Nr"] == scene.N - 3
    # each obstacle bounds every main robot point p1..pn
    assert len(spec["idx"]) == 3 * scene.n
    assert spec["centers"].shape == (3 * scene.n, 3)
    assert (spec["psi_L"] > 0).all()
    assert (spec["L_mask"] == 1).all()


def test_reduced_smoothing_matches_full_graph(scene):
    """The anchored-obstacle fold (dgp.bound_smoothing_anchored) must give
    the SAME bounds as smoothing the full (robot + obstacle) graph,
    restricted to the reduced block - it is an exact reformulation, not an
    approximation (upper-bound detours through fixed nodes never win; the
    three extra min-plus terms cover every lower-bound crossing)."""
    Nr = scene.reduced_spec()["Nr"]
    T_goal, _ = api.random_goals(scene, jax.random.PRNGKey(3), (2,))
    full = scene.instance(jnp.asarray(T_goal), dtype=jnp.float64, smooth=True)
    red = scene.instance(
        jnp.asarray(T_goal), dtype=jnp.float64, smooth=True, n_nodes=Nr
    )
    np.testing.assert_allclose(
        np.asarray(red["lb"]), np.asarray(full["lb"])[:, :Nr, :Nr],
        rtol=0, atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(red["ub"]), np.asarray(full["ub"])[:, :Nr, :Nr],
        rtol=0, atol=1e-12,
    )


def test_reduced_cost_matches_manual(scene):
    """Dense reduced cost = dense robot-only cost + explicit hinge sums."""
    spec = scene.reduced_spec()
    Nr = spec["Nr"]
    omega, psi_L, psi_U = scene.masks()
    om_r = jnp.asarray(omega[:Nr, :Nr], jnp.float64)
    pl_r = jnp.asarray(psi_L[:Nr, :Nr], jnp.float64)
    pu_r = jnp.asarray(psi_U[:Nr, :Nr], jnp.float64)
    Lm, Um = costs.make_masks(om_r, pl_r, pu_r)

    rng = np.random.default_rng(0)
    Y = jnp.asarray(rng.normal(size=(4, Nr, 3)))
    Dg = jnp.asarray(rng.random((4, Nr, Nr)))
    Dg = Dg + jnp.swapaxes(Dg, -1, -2)

    base = costs.cost(Y, Dg, om_r, pl_r, pu_r, Lm, Um)
    with_anchors = costs.cost(Y, Dg, om_r, pl_r, pu_r, Lm, Um, anchors=spec)

    manual = 0.0
    for a in range(len(spec["idx"])):
        i = spec["idx"][a]
        c = spec["centers"][a]
        dist = jnp.sum((Y[:, i, :] - c) ** 2, axis=-1)
        manual = manual + jnp.maximum(spec["psi_L"][a] - dist, 0.0) ** 2
    np.testing.assert_allclose(
        np.asarray(with_anchors - base), np.asarray(manual),
        rtol=1e-9, atol=1e-12,
    )


def test_anchored_grad_matches_autodiff(scene):
    spec = scene.reduced_spec()
    Nr = spec["Nr"]
    omega, psi_L, psi_U = scene.masks()
    om_r = jnp.asarray(omega[:Nr, :Nr], jnp.float64)
    pl_r = jnp.asarray(psi_L[:Nr, :Nr], jnp.float64)
    pu_r = jnp.asarray(psi_U[:Nr, :Nr], jnp.float64)
    Lm, Um = costs.make_masks(om_r, pl_r, pu_r)
    rng = np.random.default_rng(1)
    Y = jnp.asarray(rng.normal(size=(Nr, 3)))
    Dg = jnp.asarray(rng.random((Nr, Nr)))
    Dg = Dg + Dg.T

    f = lambda Y: costs.cost(Y, Dg, om_r, pl_r, pu_r, Lm, Um, anchors=spec)
    g_ad = jax.grad(f)(Y)
    g = costs.egrad(Y, Dg, om_r, pl_r, pu_r, Lm, Um, anchors=spec)
    # cost/grad share the reference's 1/2-scaled convention: AD = 2 * egrad
    np.testing.assert_allclose(np.asarray(g_ad), 2 * np.asarray(g), rtol=1e-9)


def test_edge_backend_matches_dense_anchored(scene):
    spec = scene.reduced_spec()
    Nr = spec["Nr"]
    omega, psi_L, psi_U = scene.masks()
    om_r = omega[:Nr, :Nr]
    pl_r = psi_L[:Nr, :Nr]
    pu_r = psi_U[:Nr, :Nr]
    omj = jnp.asarray(om_r, jnp.float64)
    plj = jnp.asarray(pl_r, jnp.float64)
    puj = jnp.asarray(pu_r, jnp.float64)
    Lm, Um = costs.make_masks(omj, plj, puj)

    ep = edge_ops.build_edge_problem(om_r, pl_r, pu_r, dim=3, anchors=spec)
    assert ep.A >= len(spec["idx"])

    rng = np.random.default_rng(2)
    Y = jnp.asarray(rng.normal(size=(4, Nr, 3)))
    Z = jnp.asarray(rng.normal(size=(4, Nr, 3)))
    Dg = jnp.asarray(rng.random((4, Nr, Nr)))
    Dg = Dg + jnp.swapaxes(Dg, -1, -2)
    dg_e = ep.edge_values(Dg)

    # dense full-matrix cost counts each edge twice with the 0.5 factor,
    # edge cost counts each once: identical totals.
    f_d, g_d = costs.cost_and_egrad(Y, Dg, omj, plj, puj, Lm, Um, anchors=spec)
    f_e, g_e = edge_ops.cost_and_egrad(ep, Y, dg_e)
    np.testing.assert_allclose(np.asarray(f_e), np.asarray(f_d), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g_e), np.asarray(g_d), rtol=1e-10)

    h_d = costs.ehess(Y, Z, Dg, omj, plj, puj, Lm, Um, anchors=spec)
    h_e = edge_ops.ehess(ep, Y, Z, dg_e)
    np.testing.assert_allclose(np.asarray(h_e), np.asarray(h_d), rtol=1e-10)


def test_pallas_kernel_anchored_parity(scene, interpret_kernel):
    """One TR step of the fused kernel with anchors matches the dense path."""
    from graphik_tpu.solvers import riemannian

    spec = scene.reduced_spec()
    Nr = spec["Nr"]
    omega, psi_L, psi_U = scene.masks()
    om_r = omega[:Nr, :Nr].astype(np.float32)
    pl_r = psi_L[:Nr, :Nr].astype(np.float32)
    pu_r = psi_U[:Nr, :Nr].astype(np.float32)

    T_goal, _ = api.random_goals(scene, jax.random.PRNGKey(0), (4,))
    inst = scene.instance(jnp.asarray(T_goal), smooth=True, dtype=jnp.float32)
    Y0 = riemannian.generate_initialization(
        inst["lb"], inst["ub"], jnp.asarray(omega, jnp.float32), 3
    ).astype(jnp.float32)[:, :Nr, :]
    Dg = inst["D_goal"].astype(jnp.float32)[:, :Nr, :Nr]

    ref = riemannian.solve(
        Y0, Dg, om_r, pl_r, pu_r,
        params=TRParams(maxiter=1, backend="dense"), anchors=spec,
    )
    pal = riemannian.solve(
        Y0, Dg, om_r, pl_r, pu_r,
        params=TRParams(maxiter=1, backend="pallas"), anchors=spec,
    )
    np.testing.assert_allclose(
        np.asarray(pal["cost"]), np.asarray(ref["cost"]), rtol=3e-5, atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(pal["num_inner"]), np.asarray(ref["num_inner"])
    )


def test_end_to_end_obstacle_solve(scene, interpret_kernel):
    """Full pipeline with the reduction: solutions avoid the obstacles."""
    T_goal, _ = api.random_goals(scene, jax.random.PRNGKey(3), (8,))
    out = api.solve_ik(
        scene, jnp.asarray(T_goal), params=TRParams.production(maxiter=150),
        dtype=jnp.float32,
    )
    assert out["Y"].shape == (8, scene.N, 3)
    # feasible solves keep every robot point outside every obstacle
    pos = scene.realization(out["q"])
    ok = np.asarray(out["success"])
    assert ok.any(), "no feasible solves at all"
    for center, radius in scene.obstacles:
        d = np.linalg.norm(
            np.asarray(pos)[:, 1:scene.n + 1, :] - np.asarray(center), axis=-1
        )
        assert (d[ok] >= radius - 1e-3).all()


def test_restart_solver_with_obstacles(scene, interpret_kernel):
    from graphik_tpu.parallel.mesh import make_restart_solver

    solver = make_restart_solver(
        scene, n_restarts=2, params=TRParams.production(maxiter=80), dtype=jnp.float32
    )
    T_goal, _ = api.random_goals(scene, jax.random.PRNGKey(4), (8,))
    out = solver(jnp.asarray(T_goal), jax.random.PRNGKey(0))
    assert out["q"].shape == (8, 6)
    assert np.isfinite(np.asarray(out["e_pos"])).all()
