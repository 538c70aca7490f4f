"""Parity tests for the edge-list (incidence-matrix) cost backends.

Oracle: the dense masked JAX path (graphik_tpu/solvers/costs.py). Covers the
pure-JAX edge functions; the fused kernel over the same form is tested in
test_tr_pallas.py. Reference semantics: graphik/solvers/costs.py:7-207.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.ops import edge
from graphik_tpu.robots import kinematics
from graphik_tpu.robots.templates import planar_from_links
from graphik_tpu.solvers import costs
from tests.test_kinematics import ur10_template


def _setup(make, seed=0):
    if make == "planar":
        ps = ProblemStructure.from_template(planar_from_links(np.ones(8)))
    else:
        ps = ProblemStructure.from_template(ur10_template())
    rng = np.random.RandomState(seed)
    q_goal = rng.uniform(-np.pi, np.pi, ps.n)
    T_goal = kinematics.pose(ps.template, jnp.asarray(q_goal), int(ps.template.ee[0]))
    inst = ps.instance(T_goal, smooth=False)
    omega, psi_L, psi_U = ps.masks()
    L_mask, U_mask = costs.make_masks(
        omega.astype(np.float64), psi_L, psi_U
    )
    ep = edge.build_edge_problem(omega, psi_L, psi_U,
                                 np.asarray(L_mask), np.asarray(U_mask),
                                 dim=ps.dim)
    D_goal = np.asarray(inst["D_goal"], np.float64)
    dense_args = tuple(
        jnp.asarray(a, jnp.float64)
        for a in (D_goal, omega.astype(np.float64), psi_L, psi_U,
                  np.asarray(L_mask), np.asarray(U_mask))
    )
    return ps, ep, D_goal, dense_args


@pytest.mark.parametrize("make", ["planar", "ur10"])
def test_edge_jax_matches_dense(make):
    ps, ep, D_goal, dense_args = _setup(make)
    rng = np.random.RandomState(5)
    B = 4
    Y = jnp.asarray(rng.randn(B, ps.N, ps.dim))
    Z = jnp.asarray(rng.randn(B, ps.N, ps.dim))
    dg_e = ep.edge_values(jnp.asarray(D_goal))  # unbatched -> broadcast
    dg_e = jnp.broadcast_to(dg_e, (B,) + dg_e.shape)

    f_ref = jax.vmap(lambda y: costs.cost(y, *dense_args))(Y)
    g_ref = jax.vmap(lambda y: costs.egrad(y, *dense_args))(Y)
    h_ref = jax.vmap(lambda y, z: costs.ehess(y, z, *dense_args))(Y, Z)

    f, g = edge.cost_and_egrad(ep, Y, dg_e)
    h = edge.ehess(ep, Y, Z, dg_e)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), atol=1e-9)
    np.testing.assert_allclose(np.asarray(h), np.asarray(h_ref), atol=1e-9)
    # cost() alone agrees with the fused version
    np.testing.assert_allclose(
        np.asarray(edge.cost(ep, Y, dg_e)), np.asarray(f), rtol=0, atol=0
    )


def test_edge_problem_compiles_active_set_only():
    ps = ProblemStructure.from_template(planar_from_links(np.ones(5)))
    omega, psi_L, psi_U = ps.masks()
    ep = edge.build_edge_problem(omega, psi_L, psi_U, dim=ps.dim)
    iu = np.triu_indices(ps.N, k=1)
    L_mask, U_mask = costs.make_masks(omega.astype(np.float64), psi_L, psi_U)
    active = ((omega != 0) | (np.asarray(L_mask) != 0) |
              (np.asarray(U_mask) != 0))[iu].sum()
    assert ep.E == active
    # unpadded: any padding is the kernel's own (ops/tr_pallas.py)
    assert ep.C.shape == (ep.E, ps.N) and ep.omega.shape == (ep.E,)
    # incidence rows: one +1, one -1 per edge
    assert np.all(ep.C.sum(axis=1) == 0)
    assert np.all(np.abs(ep.C).sum(axis=1) == 2)


def test_solver_edge_backend_matches_dense():
    """End-to-end TR solve: backend='edge' reproduces backend='dense'."""
    from graphik_tpu.solvers import riemannian
    from graphik_tpu.solvers.riemannian import TRParams

    ps = ProblemStructure.from_template(planar_from_links(np.ones(6)))
    rng = np.random.RandomState(2)
    q_goal = rng.uniform(-np.pi, np.pi, ps.n)
    T_goal = kinematics.pose(ps.template, jnp.asarray(q_goal),
                             int(ps.template.ee[0]))
    inst = ps.instance(T_goal, smooth=False)
    omega, psi_L, psi_U = ps.masks()
    Y0 = jnp.asarray(rng.randn(2, ps.N, ps.dim))
    D_goal = jnp.broadcast_to(inst["D_goal"], (2, ps.N, ps.N))

    out_d = riemannian.solve(Y0, D_goal, omega, psi_L, psi_U,
                             params=TRParams(maxiter=60, backend="dense"))
    out_e = riemannian.solve(Y0, D_goal, omega, psi_L, psi_U,
                             params=TRParams(maxiter=60, backend="edge"))
    np.testing.assert_allclose(np.asarray(out_e["cost"]),
                               np.asarray(out_d["cost"]), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.asarray(out_e["Y"]), np.asarray(out_d["Y"]),
                               rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("make", ["planar", "ur10"])
def test_residual_max_edge_matches_dense(make):
    """The feasibility-stop metric (residual_max) agrees between the dense
    and edge backends on random points."""
    ps, ep, D_goal, dense_args = _setup(make)
    rng = np.random.RandomState(3)
    for _ in range(3):
        Y = jnp.asarray(rng.randn(ps.N, ps.dim))
        r_dense = costs.residual_max(Y, *dense_args)
        dg_e = ep.edge_values(jnp.asarray(D_goal))
        r_edge = edge.residual_max(ep, Y, dg_e)
        np.testing.assert_allclose(
            float(r_dense), float(r_edge), rtol=1e-12
        )


def test_res_tol_stop_reaches_polish_basin():
    """With res_tol on, lanes stop early yet remain solvable: the stop
    implies every edge is satisfied to ~res_tol/2 of its length."""
    from graphik_tpu import api
    from graphik_tpu.solvers.riemannian import TRParams

    ps = ProblemStructure.from_template(ur10_template())
    T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(2), (6,))
    out_stop = api.solve_ik(
        ps, T_goal, params=TRParams(maxiter=500, res_tol=1e-3)
    )
    out_full = api.solve_ik(ps, T_goal, params=TRParams.production(maxiter=500))
    it_stop = np.asarray(out_stop["iterations"])
    it_full = np.asarray(out_full["iterations"])
    assert it_stop.mean() < it_full.mean()
    # stopped lanes still end at sub-cm pose error (inside the GN basin)
    stopped = it_stop < it_full
    if stopped.any():
        assert np.median(np.asarray(out_stop["e_pos"])[stopped]) < 1e-2
