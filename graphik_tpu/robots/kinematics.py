"""Batched forward kinematics and Jacobians over robot templates.

Batched replacement for the reference's per-node Python FK loops
(robot_revolute.py:85-138, robot_base.py:185-193): one `lax.scan` over the
topologically-ordered joint tree computes every frame; everything vmaps over
an instance batch.

Functions take a `RobotTemplate` (treated as static - its numpy arrays
become jit constants) and a joint-angle array ``q`` of shape (..., n).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from graphik_tpu.robots.templates import RobotTemplate
from graphik_tpu.utils import lie


def _exp(template: RobotTemplate, xi):
    return lie.se3_exp(xi) if template.dim == 3 else lie.se2_exp(xi)


def _adjoint(template: RobotTemplate, T):
    return lie.se3_adjoint(T) if template.dim == 3 else lie.se2_adjoint(T)


def prefix_products(template: RobotTemplate, q):
    """Accumulated exponential products A_i for every node.

    A_0 = T0[0]; A_i = A_{parent(i)} @ exp(S[parent(i)] * q_i), so that
    pose(node i) = A_i @ T0[i]  (robot_revolute.py:96-101).

    q: (n,) -> returns (n+1, hd, hd). vmap for batches.
    """
    tpl = template
    S = jnp.asarray(tpl.S, dtype=q.dtype)
    parents = jnp.asarray(tpl.parents)
    hd = tpl.dim + 1
    A0 = jnp.asarray(tpl.T0[0], dtype=q.dtype)

    def body(A, i):
        p = parents[i]
        step = _exp(tpl, S[p] * q[i - 1])
        Ai = A[p] @ step
        A = A.at[i].set(Ai)
        return A, None

    A_init = jnp.zeros((tpl.n + 1, hd, hd), dtype=q.dtype).at[0].set(A0)
    A, _ = jax.lax.scan(body, A_init, jnp.arange(1, tpl.n + 1))
    return A


@partial(jax.jit, static_argnums=0)
def all_poses(template: RobotTemplate, q):
    """Poses of every joint frame: (..., n) -> (..., n+1, hd, hd).

    Forced to HIGHEST matmul precision: with float32 matmuls in TF32 (~3
    decimal digits) the n-deep 4x4 pose chain accumulates ~1e-3 relative
    error - millimetres to centimetres of
    end-effector position - which silently corrupts any error metric or
    solver residual computed outside a precision scope.
    """
    tpl = template
    T0 = jnp.asarray(tpl.T0, dtype=q.dtype)

    def single(qi):
        A = prefix_products(tpl, qi)
        return A @ T0

    for _ in range(q.ndim - 1):
        single = jax.vmap(single)
    with jax.default_matmul_precision("highest"):
        return single(q)


def pose(template: RobotTemplate, q, node: int):
    """Pose of one node: (..., n) -> (..., hd, hd)."""
    return all_poses(template, q)[..., node, :, :]


def joint_positions(template: RobotTemplate, q, axis_length: float = 1.0):
    """Positions of the main (p) and auxiliary (q) points of every joint.

    Returns (p_pos, q_pos): each (..., n+1, dim). For dim == 3, the aux point
    is the frame origin translated by axis_length along the frame z-axis
    (graph_revolute.py:68-72); for dim == 2 ``q_pos`` is None.
    """
    T = all_poses(template, q)
    dim = template.dim
    p_pos = T[..., :dim, dim]
    if dim == 3:
        q_pos = p_pos + axis_length * T[..., :3, 2]
        return p_pos, q_pos
    return p_pos, None


@partial(jax.jit, static_argnums=(0, 2))
def jacobian(template: RobotTemplate, q, node: int):
    """Spatial Jacobian of `node` in [v, w] twist coordinates.

    Column i-1 (for joint angle q_i on the path) is Ad_{A_{parent(i)}} S[parent(i)]
    (robot_revolute.py:105-138). Columns for joints off the path are zero.

    q: (..., n) -> (..., 6|3, n).
    """
    tpl = template
    S = jnp.asarray(tpl.S, dtype=q.dtype)
    parents = jnp.asarray(tpl.parents)

    # Which joints move `node`: ancestors of node (path membership), static.
    on_path = _path_membership(tpl, node)  # (n+1,) bool, entry i for joint i

    def single(qi):
        A = prefix_products(tpl, qi)
        Ad = _adjoint(tpl, A)  # (n+1, tw, tw)
        cols = jnp.einsum("nij,nj->ni", Ad[parents[1:]], S[parents[1:]])
        cols = jnp.where(jnp.asarray(on_path[1:])[:, None], cols, 0.0)
        return cols.T  # (tw, n)

    for _ in range(q.ndim - 1):
        single = jax.vmap(single)
    with jax.default_matmul_precision("highest"):
        return single(q)


@partial(jax.jit, static_argnums=(0, 2))
def jacobian_geometric(template: RobotTemplate, q, node: int):
    """World-frame geometric Jacobian of `node` (robot_revolute.py:141-182).

    Column i-1 (joint q_i on the path to `node`) is
    [z_{parent(i)} x (p_node - p_{parent(i)}); z_{parent(i)}] with z/p taken
    from the current world pose of the parent frame. Off-path columns are
    zero. 3D only. q: (..., n) -> (..., 6, n).
    """
    tpl = template
    assert tpl.dim == 3, "geometric Jacobian is defined for 3D robots"
    parents = jnp.asarray(tpl.parents)
    on_path = _path_membership(tpl, node)

    def single(qi):
        T = all_poses(tpl, qi)          # (n+1, 4, 4)
        p_ee = T[node, :3, 3]
        Tp = T[parents[1:]]             # parent frame of each joint
        z = Tp[:, :3, 2]                # (n, 3)
        p = Tp[:, :3, 3]
        lin = jnp.cross(z, p_ee[None, :] - p)
        cols = jnp.concatenate([lin, z], axis=-1)  # (n, 6)
        cols = jnp.where(jnp.asarray(on_path[1:])[:, None], cols, 0.0)
        return cols.T  # (6, n)

    for _ in range(q.ndim - 1):
        single = jax.vmap(single)
    with jax.default_matmul_precision("highest"):
        return single(q)


@partial(jax.jit, static_argnums=0)
def linear_jacobians(template: RobotTemplate, q):
    """World-frame position Jacobians of EVERY node in one pass.

    (..., n) -> (..., n+1, dim, n): entry [j, :, i-1] is the velocity of
    node j per unit rate of joint i - z_{parent(i)} x (p_j - p_{parent(i)})
    in 3D, the in-plane perpendicular in 2D - zero when joint i does not
    move node j. One all_poses evaluation serves all nodes; this is the
    analytic replacement for per-constraint jacfwd in the local solver's
    obstacle terms (reference joint_angle_solver.py:83-126 recomputes a
    scipy Jacobian per constraint).
    """
    tpl = template
    dim = tpl.dim
    parents = jnp.asarray(tpl.parents)
    anc = jnp.asarray(_ancestor_matrix(tpl))  # (n+1 nodes, n joints)

    def single(qi):
        T = all_poses(tpl, qi)  # (n+1, hd, hd)
        p = T[:, :dim, dim]     # (n+1, dim)
        Tp = T[parents[1:]]
        pj = Tp[:, :dim, dim]   # (n, dim) joint pivot positions
        rel = p[:, None, :] - pj[None, :, :]  # (n+1, n, dim)
        if dim == 3:
            z = Tp[:, :3, 2]    # (n, 3)
            vel = jnp.cross(z[None, :, :], rel)
        else:
            vel = jnp.stack([-rel[..., 1], rel[..., 0]], axis=-1)
        vel = jnp.where(anc[:, :, None], vel, 0.0)
        return jnp.swapaxes(vel, -1, -2)  # (n+1, dim, n)

    for _ in range(q.ndim - 1):
        single = jax.vmap(single)
    with jax.default_matmul_precision("highest"):
        return single(q)


def _ancestor_matrix(template: RobotTemplate):
    """(n+1, n) bool: [j, i-1] = joint i is on the path root -> node j."""
    import numpy as np

    n = template.n
    anc = np.zeros((n + 1, n), dtype=bool)
    for j in range(1, n + 1):
        i = j
        while i > 0:
            anc[j, i - 1] = True
            i = int(template.parents[i])
    return anc


def _path_membership(template: RobotTemplate, node: int):
    import numpy as np

    on = np.zeros(template.n + 1, dtype=bool)
    i = node
    while i > 0:
        on[i] = True
        i = int(template.parents[i])
    return on


def random_configuration(template: RobotTemplate, key, batch_shape=()):
    """Uniform joint angles within limits (robot_base.py:76-85)."""
    lb = jnp.asarray(template.lb[1:])
    ub = jnp.asarray(template.ub[1:])
    u = jax.random.uniform(key, batch_shape + (template.n,))
    return lb + u * (ub - lb)
