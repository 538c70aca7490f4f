"""Riemannian solver tests: cost calculus vs autodiff, manifold projection
properties, and end-to-end IK accuracy (reference oracle:
experiments/simple_ik_examples/test_chain_2d_new.py - pos err < 1e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphik_tpu import api
from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.robots import kinematics
from graphik_tpu.robots.templates import planar_from_links
from graphik_tpu.solvers import costs, riemannian
from graphik_tpu.solvers.riemannian import TRParams
from tests.test_kinematics import ur10_template


@pytest.fixture(scope="module")
def planar6():
    return ProblemStructure.from_template(planar_from_links(np.ones(6)))


@pytest.fixture(scope="module")
def ur10():
    return ProblemStructure.from_template(ur10_template())


def _instance_arrays(ps, seed=0):
    rng = np.random.RandomState(seed)
    q_goal = rng.uniform(-np.pi, np.pi, ps.n)
    ee = int(ps.template.ee[0])
    T_goal = kinematics.pose(ps.template, jnp.asarray(q_goal), ee)
    inst = ps.instance(T_goal, smooth=False)
    omega, psi_L, psi_U = ps.masks()
    dt = inst["D_goal"].dtype
    omega = jnp.asarray(omega, dtype=dt)
    psi_L = jnp.asarray(psi_L, dtype=dt)
    psi_U = jnp.asarray(psi_U, dtype=dt)
    L_mask, U_mask = costs.make_masks(omega, psi_L, psi_U)
    return inst["D_goal"], omega, psi_L, psi_U, L_mask, U_mask, q_goal, T_goal


class TestCostCalculus:
    def test_egrad_matches_autodiff(self, planar6):
        args = _instance_arrays(planar6)
        D_goal, omega, psi_L, psi_U, L_mask, U_mask = args[:6]
        key = jax.random.PRNGKey(0)
        Y = jax.random.normal(key, (planar6.N, 2))
        f = lambda Y: costs.cost(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
        g_auto = jax.grad(f)(Y)
        g = costs.egrad(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
        # The reference's gradient/Hessian convention is exactly HALF the
        # true derivative of its own cost (jgrad vs jcost, costs.py:19-35 -
        # a consistent scaling of both grad and Hessian, so Newton/TR steps
        # are unchanged). We mirror it for parity.
        scale = np.linalg.norm(np.asarray(g_auto))
        np.testing.assert_allclose(
            2.0 * np.asarray(g) / scale, np.asarray(g_auto) / scale, atol=1e-9
        )

    def test_ehess_matches_autodiff_jvp(self, planar6):
        args = _instance_arrays(planar6)
        D_goal, omega, psi_L, psi_U, L_mask, U_mask = args[:6]
        key = jax.random.PRNGKey(1)
        k1, k2 = jax.random.split(key)
        Y = jax.random.normal(k1, (planar6.N, 2))
        Z = jax.random.normal(k2, (planar6.N, 2))
        g = lambda Y: costs.egrad(Y, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
        _, hz_auto = jax.jvp(g, (Y,), (Z,))
        hz = costs.ehess(Y, Z, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
        scale = np.linalg.norm(np.asarray(hz_auto))
        np.testing.assert_allclose(
            np.asarray(hz) / scale, np.asarray(hz_auto) / scale, atol=1e-9
        )

    def test_cost_zero_at_truth(self, planar6):
        D_goal, omega, psi_L, psi_U, L_mask, U_mask, q_goal, _ = _instance_arrays(
            planar6
        )
        Y_true = planar6.realization(jnp.asarray(q_goal))
        f = costs.cost(Y_true, D_goal, omega, psi_L, psi_U, L_mask, U_mask)
        assert float(f) < 1e-12


class TestManifold:
    def test_proj_is_horizontal(self):
        """After projection, Y^T Z - Z^T Y = 0 (the Lyapunov condition)."""
        key = jax.random.PRNGKey(2)
        k1, k2 = jax.random.split(key)
        Y = jax.random.normal(k1, (10, 3))
        Z = jax.random.normal(k2, (10, 3))
        H = riemannian.manifold_proj(Y, Z)
        C = Y.T @ H - H.T @ Y
        np.testing.assert_allclose(np.asarray(C), 0.0, atol=1e-6)

    def test_proj_idempotent(self):
        key = jax.random.PRNGKey(3)
        k1, k2 = jax.random.split(key)
        Y = jax.random.normal(k1, (8, 3))
        Z = jax.random.normal(k2, (8, 3))
        H = riemannian.manifold_proj(Y, Z)
        H2 = riemannian.manifold_proj(Y, H)
        np.testing.assert_allclose(np.asarray(H), np.asarray(H2), atol=1e-6)

    def test_proj_removes_vertical(self):
        """Vertical vectors Y @ Omega (Omega skew) project to ~0."""
        key = jax.random.PRNGKey(4)
        Y = jax.random.normal(key, (8, 3))
        Om = jnp.array([[0.0, 1.0, -0.5], [-1.0, 0.0, 2.0], [0.5, -2.0, 0.0]])
        V = Y @ Om
        H = riemannian.manifold_proj(Y, V)
        np.testing.assert_allclose(np.asarray(H), 0.0, atol=1e-6)


class TestEndToEnd:
    def test_planar_chain_accuracy(self, planar6):
        """Batched solve of 4 random goals, no-limits path init from zero
        config: pos error < 1e-4 for all (test_chain_2d_new.py:82)."""
        ps = planar6
        key = jax.random.PRNGKey(5)
        T_goal, _ = api.random_goals(ps, key, (4,))
        Y_init = ps.realization(jnp.zeros(ps.n))
        out = api.solve_ik(
            ps, T_goal, params=TRParams.production(maxiter=1500), use_limits=False,
            Y_init=Y_init,
        )
        assert np.all(np.asarray(out["e_pos"]) < 1e-4), out["e_pos"]

    def test_planar_chain_with_limits_and_bounds_init(self, planar6):
        ps = planar6
        key = jax.random.PRNGKey(6)
        T_goal, _ = api.random_goals(ps, key, (4,))
        out = api.solve_ik(ps, T_goal, params=TRParams.production(maxiter=1500))
        # limits path: success criterion pos/rot err < 0.01
        assert np.all(np.asarray(out["e_pos"]) < 1e-2), out["e_pos"]
        assert np.all(np.asarray(out["e_rot"]) < 1e-2), out["e_rot"]

    def test_conjugate_gradient_backend(self, planar6):
        """The CG solver option (reference riemannian_solver.py:51-59,
        params["solver"]="ConjugateGradient") solves the same instances the
        TR solver does, through the same api pipeline."""
        from graphik_tpu.solvers.riemannian import CGParams

        ps = planar6
        T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(6), (4,))
        out_cg = api.solve_ik(ps, T_goal, params=CGParams(maxiter=1500))
        assert np.all(np.asarray(out_cg["e_pos"]) < 1e-2), (
            out_cg["e_pos"], out_cg["gradnorm"], out_cg["iterations"],
        )
        assert np.all(np.asarray(out_cg["e_rot"]) < 1e-2)

    def test_cg_edge_backend_matches_dense(self, planar6):
        """CG over the compiled edge-list cost equals the dense masked cost
        path (same algorithm, different data movement)."""
        from graphik_tpu.solvers.riemannian import CGParams

        ps = planar6
        T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(9), (2,))
        Y_init = ps.realization(jnp.zeros(ps.n))
        outs = {}
        for backend in ("dense", "edge"):
            outs[backend] = api.solve_ik(
                ps, T_goal, params=CGParams(maxiter=400, backend=backend),
                use_limits=True, Y_init=Y_init, polish=False,
            )
        np.testing.assert_allclose(
            np.asarray(outs["edge"]["cost"]),
            np.asarray(outs["dense"]["cost"]), rtol=1e-6, atol=1e-10,
        )
        np.testing.assert_allclose(
            np.asarray(outs["edge"]["e_pos"]),
            np.asarray(outs["dense"]["e_pos"]), atol=1e-6,
        )

    def test_cg_matches_tr_cost_no_limits(self, planar6):
        """From the SAME deterministic init, CG and TR reach comparable
        final costs on the unconstrained EDM completion."""
        from graphik_tpu.solvers.riemannian import CGParams

        ps = planar6
        T_goal, _ = api.random_goals(ps, jax.random.PRNGKey(8), (3,))
        Y_init = ps.realization(jnp.zeros(ps.n))
        tr = api.solve_ik(ps, T_goal, params=TRParams.production(maxiter=1500),
                          use_limits=False, Y_init=Y_init, polish=False)
        cg = api.solve_ik(ps, T_goal, params=CGParams(maxiter=3000),
                          use_limits=False, Y_init=Y_init, polish=False)
        assert np.all(np.asarray(cg["cost"]) < 1e-8), cg["cost"]
        assert np.all(np.asarray(cg["e_pos"]) < 1e-3), cg["e_pos"]
        assert np.all(np.asarray(tr["cost"]) < 1e-8)

    def test_ur10_accuracy(self, ur10):
        key = jax.random.PRNGKey(7)
        T_goal, _ = api.random_goals(ur10, key, (4,))
        out = api.solve_ik(ur10, T_goal, params=TRParams.production(maxiter=2000))
        assert np.all(np.asarray(out["e_pos"]) < 1e-2), (
            out["e_pos"], out["e_rot"], out["gradnorm"], out["iterations"],
        )
        assert np.all(np.asarray(out["e_rot"]) < 1e-2)


def test_default_params_reference_faithful():
    """Library defaults must match the reference's stopping semantics
    (gradnorm/maxiter only; trust_region.py:413-422): no plateau stop, no
    residual early-stop. The tuned serving knobs live in the explicit
    TRParams.production()/CGParams.production() presets."""
    from graphik_tpu.solvers.riemannian import CGParams, TRParams

    for d in (TRParams(), CGParams()):
        assert d.plateau_every == 0
    assert TRParams().res_tol == 0.0
    assert TRParams.production().plateau_every == 16
    assert CGParams.production().plateau_every == 16
    # overrides pass through
    assert TRParams.production(maxiter=7).maxiter == 7


@pytest.mark.parametrize(
    "backend, dtype, expect",
    [
        (None, "float32", "pallas"),
        (None, "float64", "dense"),
        ("edge", "float32", "edge"),
        ("dense", "float32", "dense"),
        ("edge", "float64", "edge"),
        ("pallas", "float32", "pallas"),
    ],
)
def test_resolve_backend(backend, dtype, expect):
    """The TR backend comes from TRParams.backend or the dtype - never from
    the platform."""
    from graphik_tpu.solvers.riemannian import resolve_backend

    assert resolve_backend(backend, dtype) == expect


@pytest.mark.parametrize("backend, dtype", [("pallas", "float64"),
                                            ("cuda", "float32")])
def test_resolve_backend_rejects(backend, dtype):
    from graphik_tpu.solvers.riemannian import resolve_backend

    with pytest.raises(ValueError):
        resolve_backend(backend, dtype)
