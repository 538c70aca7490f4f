"""CIDGIK in obstacle scenes: the reference paper's headline capability.

The reference's `solve_with_cidgik` passes ranges=True by default, which
activates the obstacle/limit inequality LMIs
(/root/reference/graphik/solvers/convex_iteration.py:279-319, constraint
builders /root/reference/graphik/solvers/sdp_snl.py:356-398), and its
example solves UR10 over the table environment. These tests prove the
f32 ADMM path end-to-end: the obstacle inequalities enter the compiled
constraint tables, the solve succeeds on certified-feasible goals, and the
returned configurations CLEAR the obstacles.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from graphik_tpu import api
from graphik_tpu.graphs.problem import ProblemStructure
from graphik_tpu.robots import kinematics
from graphik_tpu.solvers import cidgik
from graphik_tpu.solvers import local as local_solver
from graphik_tpu.solvers.cidgik import CidgikParams, compile_cidgik
from graphik_tpu.solvers.local import LocalParams
from tests.test_kinematics import ur10_template

OBSTACLE = (np.array([0.4, 0.4, 0.6]), 0.25)


@pytest.fixture(scope="module")
def ur10_obs():
    return ProblemStructure.from_template(
        ur10_template(), obstacles=[OBSTACLE]
    )


@pytest.fixture(scope="module")
def comp_obs(ur10_obs):
    return compile_cidgik(ur10_obs)


@pytest.fixture(scope="module")
def feasible_goals(ur10_obs):
    """FK-certified goals whose generating configuration clears the
    obstacle (the reference's implicit experiment protocol: goals come
    from feasible configurations)."""
    rng = np.random.RandomState(0)
    goals = []
    while len(goals) < 4:
        q = rng.uniform(-np.pi, np.pi, 6)
        pos = ur10_obs.realization(jnp.asarray(q))
        _, ok = ur10_obs.check_distance_limits(pos)
        if bool(ok):
            goals.append(
                np.asarray(kinematics.pose(ur10_obs.template, jnp.asarray(q), 6))
            )
    return jnp.asarray(np.stack(goals))


class TestObstacleConstraints:
    def test_obstacle_inequalities_compiled(self, ur10_obs, comp_obs):
        """The obstacle bound edges appear as free-anchor inequality rows
        (sdp_snl.py:356-398 analogue): one per (free p-node, obstacle)."""
        comp_plain = compile_cidgik(
            ProblemStructure.from_template(ur10_template())
        )
        extra = comp_obs.m_in - comp_plain.m_in
        assert extra >= 5, (comp_obs.m_in, comp_plain.m_in)
        # lower bounds are the squared obstacle radius on those rows
        r2 = OBSTACLE[1] ** 2
        assert np.isclose(comp_obs.in_fa_lo, r2).sum() >= 5

    def test_inequalities_hold_at_feasible_points(self, ur10_obs, comp_obs):
        rng = np.random.RandomState(1)
        found = 0
        while found < 2:
            q = rng.uniform(-np.pi, np.pi, 6)
            pos = np.asarray(ur10_obs.realization(jnp.asarray(q)))
            _, ok = ur10_obs.check_distance_limits(jnp.asarray(pos))
            if not bool(ok):
                continue
            found += 1
            anchors_pos = jnp.asarray(pos[comp_obs.anchor_idx])
            A_eq, b_eq, A_in, lo, hi = cidgik._constraint_matrices(
                comp_obs, anchors_pos, jnp.float64
            )
            d, s = comp_obs.d, comp_obs.s
            X = pos[comp_obs.free_idx]
            Z = np.zeros((s, s))
            Z[:d, :d] = np.eye(d)
            Z[d:, :d] = X
            Z[:d, d:] = X.T
            Z[d:, d:] = X @ X.T
            v = np.einsum("mij,ij->m", np.asarray(A_in), Z)
            assert np.all(v >= np.asarray(lo) - 1e-6)
            assert np.all(v <= np.asarray(hi) + 1e-6)


class TestObstacleSolve:
    def test_cidgik_solves_and_clears_obstacle(
        self, ur10_obs, comp_obs, feasible_goals
    ):
        """Production CIDGIK pipeline (ADMM + GN polish) on UR10 + sphere:
        >= 3/4 feasible goals at the BASELINE mm criterion AND the returned
        configurations clear the obstacle. The reference has no automated
        CIDGIK obstacle assertion at all (SURVEY.md section 4)."""
        out = cidgik.solve_cidgik(
            comp_obs, feasible_goals,
            params=CidgikParams(admm_iters=800, max_outer=10),
        )
        # raw ADMM already clears the obstacle at every goal
        _, ok_raw = ur10_obs.check_distance_limits(
            ur10_obs.realization(out["q"])
        )
        assert np.asarray(ok_raw).all(), out["feas"]

        pol = local_solver.solve_local(
            ur10_obs, feasible_goals, out["q"], LocalParams(maxiter=60)
        )
        e_pos, e_rot = api.pose_error(ur10_obs, pol["q"], feasible_goals)
        viol, ok = ur10_obs.check_distance_limits(
            ur10_obs.realization(pol["q"])
        )
        e_pos, e_rot = np.asarray(e_pos), np.asarray(e_rot)
        mm = (e_pos < 1e-3) & (e_rot < np.deg2rad(1.0)) & np.asarray(ok)
        assert mm.sum() >= 3, (e_pos, e_rot, np.asarray(viol))
        # the typical polished goal reaches machine precision
        assert np.median(e_pos[mm]) < 1e-8, e_pos

    def test_ns_cone_projection_matches(self, comp_obs, feasible_goals,
                                        ur10_obs):
        """Newton-Schulz cone projection (the production fast path) lands the same
        basins as the Jacobi-eigh projection on the obstacle scene."""
        out = cidgik.solve_cidgik(
            comp_obs, feasible_goals,
            params=CidgikParams(
                admm_iters=800, max_outer=10, cone_ns_iters=14
            ),
        )
        pol = local_solver.solve_local(
            ur10_obs, feasible_goals, out["q"], LocalParams(maxiter=60)
        )
        e_pos, e_rot = api.pose_error(ur10_obs, pol["q"], feasible_goals)
        _, ok = ur10_obs.check_distance_limits(
            ur10_obs.realization(pol["q"])
        )
        mm = (
            (np.asarray(e_pos) < 1e-3)
            & (np.asarray(e_rot) < np.deg2rad(1.0))
            & np.asarray(ok)
        )
        assert mm.sum() >= 3, (e_pos, e_rot)
