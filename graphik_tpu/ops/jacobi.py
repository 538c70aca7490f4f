"""Fixed-sweep parallel-ordered Jacobi eigensolver for small symmetric
matrices.

XLA's jnp.linalg.eigh lowers to a large iterative program (QDWH); nested
inside the CIDGIK ADMM's while_loop x scan x vmap it makes compile time
explode (>25 min for the batched solver). This Jacobi variant runs a FIXED
number of round-robin sweeps where each round applies floor(s/2) disjoint
Givens rotations as one (s, s) rotation-matrix multiply - a handful of ops
inside a fori_loop, so the compiled program is tiny, and every op is a
batched matmul/elementwise op.

Accuracy: Jacobi converges quadratically; `sweeps=10` reaches ~1e-13 (f64)
/ ~1e-6 (f32) off-diagonal residual for s <= 32 - far beyond the ADMM
tolerance that consumes it.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _round_robin_schedule(s: int) -> np.ndarray:
    """Tournament pairing: (rounds, 2, floor(s/2)) index table.

    Round r pairs `top[i]` with `bot[i]`; odd s sits one index out per
    round (classic circle method).
    """
    n = s + (s % 2)
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        top = players[: n // 2]
        bot = players[n // 2:][::-1]
        pairs = [(a, b) for a, b in zip(top, bot) if a < s and b < s]
        rounds.append(pairs)
        players = [players[0]] + [players[-1]] + players[1:-1]
    m = min(len(p) for p in rounds)
    # drop the overflow pair on odd s rounds so the table is rectangular
    return np.asarray([p[:m] for p in rounds], dtype=np.int32)  # (R, m, 2)


@partial(jax.jit, static_argnums=(1,))
def jacobi_eigh(A, sweeps: int = 10):
    """Eigendecomposition of symmetric A (..., s, s) -> (eigvals ascending,
    eigvecs); drop-in for jnp.linalg.eigh on small matrices.
    """
    A = jnp.asarray(A)
    s = A.shape[-1]
    dt = A.dtype
    sched = _round_robin_schedule(s)  # (R, m, 2)
    R, m, _ = sched.shape
    p_tab = jnp.asarray(sched[..., 0])
    q_tab = jnp.asarray(sched[..., 1])
    eye = jnp.eye(s, dtype=dt)
    eps_m = jnp.asarray(np.finfo(np.dtype(dt)).eps, dt)
    tiny = jnp.asarray(np.finfo(np.dtype(dt)).tiny, dt)

    def round_step(carry, r):
        M, V = carry
        p = p_tab[r]  # (m,)
        q = q_tab[r]
        app = M[..., p, p]
        aqq = M[..., q, q]
        apq = M[..., p, q]
        # stable Givens angle: tan(2 theta) = 2 apq / (app - aqq).
        # Skip the rotation when apq is negligible RELATIVE to the diagonal
        # (already annihilated - includes exact-zero padded rows). The old
        # absolute-tiny substitute let tau overflow to +-inf when
        # |aqq - app| / tiny exceeded the float range, and sign(inf) then
        # produced NaN that wiped the whole decomposition.
        use = jnp.abs(apq) > eps_m * (jnp.abs(app) + jnp.abs(aqq)) + tiny
        tau = (aqq - app) / jnp.where(use, 2.0 * apq, 1.0)
        # Zero-safe sign: tau == 0 (app == aqq exactly) needs the full
        # 45-degree rotation t = 1, but jnp.sign(0) = 0 would turn it into a
        # no-op and the off-diagonal entry would never be annihilated.
        sgn = jnp.where(tau >= 0, 1.0, -1.0).astype(dt)
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(use, t, 0.0)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        sn = t * c

        # disjoint pairs: build one (s, s) rotation G for the whole round
        G = eye
        bcast = jnp.broadcast_to(G, M.shape[:-2] + (s, s))
        G = bcast.at[..., p, p].set(c)
        G = G.at[..., q, q].set(c)
        G = G.at[..., p, q].set(sn)
        G = G.at[..., q, p].set(-sn)
        M_new = jnp.einsum("...ji,...jk,...kl->...il", G, M, G)
        V_new = jnp.einsum("...ij,...jk->...ik", V, G)
        return (M_new, V_new), None

    def sweep(carry, _):
        carry, _ = jax.lax.scan(round_step, carry, jnp.arange(R))
        return carry, None

    V0 = jnp.broadcast_to(eye, A.shape)
    (M, V), _ = jax.lax.scan(sweep, (A, V0), None, length=sweeps)
    lam = jnp.diagonal(M, axis1=-2, axis2=-1)
    order = jnp.argsort(lam, axis=-1)
    lam_sorted = jnp.take_along_axis(lam, order, axis=-1)
    V_sorted = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return lam_sorted, V_sorted
