"""Batched top-k subspace extraction via orthogonal iteration.

The MDS initialization (riemannian_solver.py:67-75 semantics) needs two
small symmetric eigendecompositions per instance: the Gram factor and the
dominant edge-scatter directions. Full Jacobi (ops/jacobi.py) runs ~120
sequential rotation rounds of scatter-heavy ops; at batch 4096 the init
stage costs as much as the TR solve itself. But the init only needs the
DOMINANT subspace, and only approximately - orthogonal iteration gets it
in ~10 rounds of batched (n, n) x (n, k) matmuls plus a k x k Cholesky-QR,
all plain batched matmuls.

Cholesky-QR orthonormalization: Q = Z R^{-1} with R^T R = Z^T Z, computed
through the explicit HIGHEST-precision factor (ops/linalg.spd_inverse_factor)
so reduced-precision (TF32) matmul passes cannot corrupt the tiny k x k
factor.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from graphik_tpu.ops.linalg import spd_inverse_factor


def _cholqr(Z, eps):
    G = jnp.einsum("...nk,...nl->...kl", Z, Z)
    k = G.shape[-1]
    G = G + eps * (
        jnp.trace(G, axis1=-2, axis2=-1)[..., None, None] + 1e-30
    ) * jnp.eye(k, dtype=Z.dtype)
    Linv = spd_inverse_factor(G)  # G^-1 = Linv^T Linv
    # Q = Z (L^T)^-1 = Z Linv^T
    return jnp.einsum("...nk,...lk->...nl", Z, Linv)


def _orthonormalize(Z, eps):
    """CholeskyQR2 of (..., n, k): Q with Q^T Q = I, range(Q) = range(Z).

    Two passes: rank-deficient blocks (e.g. an oversampled block on an
    exactly low-rank matrix) leave pass one's regularized output visibly
    non-orthonormal, which would bias the Rayleigh-Ritz values; the second
    pass restores orthonormality to working precision."""
    return _cholqr(_cholqr(Z, eps), eps)


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def topk_eigh(A, k: int, iters: int = 10, psd: bool = False,
              oversample: int = 3, rr_sweeps: int = 6):
    """Approximate top-k (algebraically largest) eigenpairs of symmetric A.

    A: (..., n, n) symmetric. Returns (lam (..., k) descending, Q (..., n, k)).
    Indefinite A is shifted by a Gershgorin lower bound (eigenvectors
    unchanged, all eigenvalues nonnegative) unless psd=True skips the shift.

    Orthogonal iteration on an `oversample`-enlarged block, then a
    Rayleigh-Ritz refinement on the (k+p) x (k+p) compression (fixed-sweep
    Jacobi): the top-k Ritz values converge at (lam_{k+p+1}/lam_k)^iters,
    far faster than the plain block's (lam_{k+1}/lam_k)^iters when interior
    eigenvalues cluster - which they do for the Gram/scatter matrices of
    the MDS init path.

    Deterministic start: the leading columns of the shifted matrix (full
    column rank for the generic inputs of the init path; the Cholesky-QR
    regularization absorbs degenerate batches).
    """
    A = jnp.asarray(A)
    n = A.shape[-1]
    kk = min(k + oversample, n)
    eps = 10.0 * jnp.finfo(A.dtype).eps
    if psd:
        M = A
    else:
        # Gershgorin: lam_min >= min_i (a_ii - sum_{j!=i} |a_ij|)
        diag = jnp.diagonal(A, axis1=-2, axis2=-1)
        row = jnp.sum(jnp.abs(A), axis=-1) - jnp.abs(diag)
        lower = jnp.min(diag - row, axis=-1)
        shift = jnp.maximum(-lower, 0.0)[..., None, None]
        M = A + shift * jnp.eye(n, dtype=A.dtype)
    # Tiny full-rank shift: on an exactly rank-r matrix with kk > r the
    # iteration M @ Q would collapse every block column into range(M) and
    # the block could never stay orthonormal; shifting by ~sqrt(eps) keeps
    # complement directions alive as genuine (degenerate) eigendirections.
    # Ritz values are computed against the ORIGINAL A, so this does not
    # bias the result.
    delta = jnp.sqrt(eps) * (
        jnp.trace(jnp.abs(M), axis1=-2, axis2=-1)[..., None, None] / n + 1e-30
    )
    M = M + delta * jnp.eye(n, dtype=A.dtype)

    # Single-pass Cholesky-QR every SECOND power step (stability only needs
    # the basis roughly conditioned between steps - cond(Z^T Z) grows as
    # (lam_1/lam_kk)^4 over two unwhitened steps, well within f32); the
    # two-pass orthonormalize runs once at the end, where Rayleigh-Ritz
    # actually needs Q^T Q = I.
    Q = _cholqr(M[..., :, :kk], eps)

    def body(_, Q):
        Q = jnp.einsum("...nm,...mk->...nk", M, Q)
        return _cholqr(jnp.einsum("...nm,...mk->...nk", M, Q), eps)

    Q = jax.lax.fori_loop(0, (iters + 1) // 2, body, Q)
    Q = _orthonormalize(Q, eps)
    # Rayleigh-Ritz on the ORIGINAL matrix (shift-free): B = Q^T A Q
    AQ = jnp.einsum("...nm,...mk->...nk", A, Q)
    B = jnp.einsum("...nk,...nl->...kl", Q, AQ)
    if kk > k:
        from graphik_tpu.ops.jacobi import jacobi_eigh

        lamB, W = jacobi_eigh(B, sweeps=rr_sweeps)  # ascending
        lam = jnp.flip(lamB, axis=-1)[..., :k]
        Wd = jnp.flip(W, axis=-1)[..., :, :k]
        Q = jnp.einsum("...nk,...kl->...nl", Q, Wd)
    else:
        lam = jnp.diagonal(B, axis1=-2, axis2=-1)
        order = jnp.argsort(-lam, axis=-1)
        lam = jnp.take_along_axis(lam, order, axis=-1)
        Q = jnp.take_along_axis(Q, order[..., None, :], axis=-1)
    return lam, Q


@partial(jax.jit, static_argnums=(1, 2))
def factor_psd_topk(A, k: int, iters: int = 10):
    """Rank-k PSD factor X (..., n, k) with X X^T ~ closest-PSD_k(A).

    Subspace-iteration analogue of dgp.factor_psd restricted to the top-k
    eigenpairs. Runs UNSHIFTED (magnitude-dominant) iteration: near-metric
    Gram matrices have |lam_min| < lam_3 (measured ~0.64 max ratio on the
    bound-sampled UR10 instance family), so the top-k magnitude block
    always contains the top-k algebraic directions, and the Gershgorin
    shift's convergence penalty is avoided. Negative Rayleigh-Ritz values
    (the reference's factor clamp, dgp.py:150-159) clamp to zero.
    """
    lam, Q = topk_eigh(A, k, iters, psd=True)
    return Q * jnp.sqrt(jnp.maximum(lam, 0.0))[..., None, :]
