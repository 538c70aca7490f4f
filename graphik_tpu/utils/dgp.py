"""Distance-geometry core: Gram <-> EDM <-> positions, MDS, bound smoothing.

Batched JAX counterparts of the reference's numpy/networkx DGP layer
(/root/reference/graphik/utils/dgp.py). Graph-shaped inputs are replaced by
dense masked matrices; all functions broadcast over leading batch dims.

Distance matrices ``D`` hold *squared* distances (matching
``distance_matrix_from_graph``, dgp.py:42-50). Bound matrices ``lb``/``ub``
hold *unsquared* distances (matching ``bound_smoothing``, dgp.py:192-231).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Sentinel for "no edge" in min-plus shortest paths. Large but far from
# overflow so sums of two stay representable in float32.
BIG = 1e9


# ---------------------------------------------------------------------------
# Gram / EDM / positions
# ---------------------------------------------------------------------------

def gram_from_distance_matrix(D):
    """Double-centered Gram matrix from a squared EDM (dgp.py:28-31)."""
    D = jnp.asarray(D)
    n = D.shape[-1]
    row = jnp.mean(D, axis=-1, keepdims=True)
    col = jnp.mean(D, axis=-2, keepdims=True)
    tot = jnp.mean(D, axis=(-2, -1), keepdims=True)
    return -0.5 * (D - row - col + tot)


def distance_matrix_from_gram(X):
    """Squared EDM from a Gram matrix (dgp.py:34-35)."""
    X = jnp.asarray(X)
    d = jnp.diagonal(X, axis1=-2, axis2=-1)
    return d[..., :, None] + d[..., None, :] - 2.0 * X


def distance_matrix_from_pos(Y):
    """Squared EDM of an (..., N, d) point set (dgp.py:38-39)."""
    Y = jnp.asarray(Y)
    G = jnp.einsum("...ik,...jk->...ij", Y, Y)
    return distance_matrix_from_gram(G)


# ---------------------------------------------------------------------------
# Spectral factorization / MDS init
# ---------------------------------------------------------------------------

def _eigh(A, sweeps=0):
    """Symmetric eigendecomposition; sweeps>0 selects the fixed-sweep
    Jacobi solver (ops/jacobi.py) whose compiled program is tiny and fast
    for the small batched matrices of the init path."""
    if sweeps:
        from graphik_tpu.ops.jacobi import jacobi_eigh

        return jacobi_eigh(A, sweeps=sweeps)
    return jnp.linalg.eigh(A)


def factor_psd(A, eps=0.0, eigh_sweeps=0):
    """Return X with XX^T ~= closest-PSD(A), eigenvalues in descending order.

    Batched equivalent of `factor` (dgp.py:150-159): eigendecompose, clamp
    negative eigenvalues, scale eigenvectors by sqrt(eigval), order columns
    by descending eigenvalue. Output keeps all N columns (fixed shape);
    columns for near-zero eigenvalues are ~0 and harmless downstream.
    """
    A = jnp.asarray(A)
    evals, evecs = _eigh(A, eigh_sweeps)  # ascending
    evals = jnp.where(evals > eps, evals, 0.0)
    X = evecs * jnp.sqrt(evals)[..., None, :]
    return jnp.flip(X, axis=-1)


def mds(B, eps=1e-8, eigh_sweeps=0):
    """Classic multidimensional scaling of a Gram matrix (dgp.py:163-171).

    Unlike the reference we keep a fixed number of columns (all N) so the
    result is jit-friendly; trailing columns carry ~zero energy.
    """
    return factor_psd(B, eps=eps, eigh_sweeps=eigh_sweeps)


def linear_projection(P, F, dim, eigh_sweeps=0, subspace_iters=0):
    """Project points onto the dominant `dim`-dim subspace of the edge scatter.

    Batched equivalent of dgp.py:174-183: S = sum over nonzero (i,j) of F of
    outer(P_i - P_j); project P onto the top-`dim` eigenvectors of S.
    `F` is a dense (N, N) nonnegative mask (static or batched).
    subspace_iters > 0 extracts the dominant subspace by orthogonal
    iteration (ops/subspace.topk_eigh) instead of a full eigendecomposition
    - batched matmuls instead of an eigendecomposition.
    """
    P = jnp.asarray(P)
    F = jnp.asarray(F)
    mask = (F != 0).astype(P.dtype)
    # S = sum_ij mask_ij (P_i - P_j)(P_i - P_j)^T
    deg_i = jnp.sum(mask, axis=-1)  # (..., N)
    deg_j = jnp.sum(mask, axis=-2)
    # sum_ij m_ij P_i P_i^T = sum_i deg_i P_i P_i^T   (and symmetric for j)
    PtP_i = jnp.einsum("...i,...ik,...il->...kl", deg_i, P, P)
    PtP_j = jnp.einsum("...j,...jk,...jl->...kl", deg_j, P, P)
    cross = jnp.einsum("...ij,...ik,...jl->...kl", mask, P, P)
    S = PtP_i + PtP_j - cross - jnp.swapaxes(cross, -1, -2)
    if subspace_iters:
        from graphik_tpu.ops.subspace import topk_eigh

        _, basis = topk_eigh(S, dim, subspace_iters, psd=True)
    else:
        _, eigvec = _eigh(S, eigh_sweeps)  # ascending
        basis = jnp.flip(eigvec, axis=-1)[..., :, :dim]
    return P @ basis


def sample_distance_matrix(lb, ub, key=None, frac=0.9):
    """Squared EDM sampled inside [lb, ub] bounds (dgp.py:187-189).

    With ``key=None`` this is the deterministic initialization used by
    ``RiemannianSolver.generate_initialization`` (riemannian_solver.py:67-75):
    D = (lb + frac * (ub - lb))**2. With a PRNG key, ``frac`` is uniform.
    """
    lb = jnp.asarray(lb)
    ub = jnp.asarray(ub)
    if key is not None:
        frac = jax.random.uniform(key, lb.shape, dtype=lb.dtype)
    return (lb + frac * (ub - lb)) ** 2


# ---------------------------------------------------------------------------
# Bound smoothing (triangle-inequality propagation)
# ---------------------------------------------------------------------------

def _minplus(A, B):
    """Min-plus (tropical) matrix product: C_ij = min_k A_ik + B_kj.

    Unrolled over k as (..., N, N) elementwise minima: the equivalent
    reduction over a (..., N, N, N) broadcast lets XLA:GPU pick a Triton
    block-level fusion whose (32, 16, 16) tile asks for more shared memory
    than an H100 block has (262144 > 232448 bytes) at batch 8192.
    """
    C = A[..., :, 0:1] + B[..., 0:1, :]
    for k in range(1, A.shape[-1]):
        C = jnp.minimum(C, A[..., :, k:k + 1] + B[..., k:k + 1, :])
    return C


def _minplus_closure(A, n_iter):
    """Shortest-path closure of A (zero diagonal) via repeated squaring."""
    def body(_, M):
        return jnp.minimum(M, _minplus(M, M))
    return jax.lax.fori_loop(0, n_iter, body, A)


def bound_smoothing(L, U, edge_mask, n_iter=None):
    """Propagate distance bounds through the doubled (bipartite) graph.

    Batched equivalent of `bound_smoothing` (dgp.py:192-231, after Havel
    2002). The reference runs Bellman-Ford on a 2N-node digraph with blocks

        W = [[ A, B ],
             [ inf, A ]]   A_uv = U(u,v) (upper bounds), B_uv = -L(u,v),
                           B_uu = 0.

    Every original->shadow path crosses the B block exactly once, so

        upper = A*              (min-plus closure)
        cross = A* (x) B (x) A*     and   lower = max(0, -cross).

    Parameters
    ----------
    L, U : (..., N, N) unsquared lower/upper bounds on edges.
    edge_mask : (..., N, N) bool, True where an edge with bounds exists.

    Returns
    -------
    (lb, ub) : (..., N, N) smoothed unsquared bounds, zero diagonal.
    """
    L = jnp.asarray(L)
    U = jnp.asarray(U)
    n = L.shape[-1]
    eye = jnp.eye(n, dtype=bool)

    A = jnp.where(edge_mask, U, BIG)
    A = jnp.where(eye, 0.0, A)

    B = jnp.where(edge_mask, -L, BIG)
    B = jnp.where(eye, 0.0, B)

    import math

    if n_iter is None:
        n_iter = max(1, math.ceil(math.log2(n)) + 1)
    # Partial closures (smaller n_iter) remain VALID bounds: every closure
    # iterate upper-bounds the true shortest path (monotone decreasing),
    # so ub stays an upper bound and lb = max(0, -cross) a lower bound -
    # just looser. The init only samples inside the bounds, so production
    # configs may trade closure depth for wall time.
    Astar = _minplus_closure(A, n_iter)
    cross = _minplus(_minplus(Astar, B), Astar)

    ub = Astar
    lb = jnp.maximum(0.0, -cross)
    lb = jnp.where(eye, 0.0, lb)
    ub = jnp.where(eye, 0.0, ub)
    return lb, ub


def bound_smoothing_anchored(L, U, edge_mask, U_ro, L_ro, D_oo,
                             n_iter=None):
    """Bound smoothing with fixed-position side nodes folded in closed form.

    Equivalent to `bound_smoothing` on the (M + no)-node graph containing
    the M reduced nodes plus `no` side nodes at known positions (obstacles),
    restricted to the reduced block - without the (M+no)^3 log(M+no) cost.

    Why this is exact (not an approximation):
    * Upper bounds: a detour through a side node o costs at least
      U(u, a) + d(a, o) + d(o, a') + U(a', v) for anchors a, a'; by the
      triangle inequality d(a, o) + d(o, a') >= d(a, a'), so the detour
      never beats the direct reduced-graph path. ub is therefore the
      reduced closure unchanged.
    * Lower bounds: every original->shadow path crosses the -L block exactly
      once (see `bound_smoothing`). The crossing edge lies either inside the
      reduced block (the reduced `cross` term), between a reduced node and a
      side node (terms T1 and its transpose), or between two side nodes
      (term T3). The A*-segments flanking the crossing never benefit from
      side-node detours by the argument above, so three extra min-plus
      products over the (M, no) blocks cover all paths.

    Parameters
    ----------
    L, U, edge_mask : as `bound_smoothing`, over the M reduced nodes.
    U_ro : (..., M, no) upper bounds reduced->side (exact distances on
        anchor rows, obstacle-edge uppers elsewhere; BIG where no edge).
    L_ro : (..., M, no) lower bounds reduced->side (exact distances on
        anchor rows, obstacle radii on bound-edge rows; 0 where none).
    D_oo : (no, no) exact side-side distances.

    Returns (lb, ub) over the M reduced nodes.
    """
    L = jnp.asarray(L)
    U = jnp.asarray(U)
    n = L.shape[-1]
    eye = jnp.eye(n, dtype=bool)

    A = jnp.where(edge_mask, U, BIG)
    A = jnp.where(eye, 0.0, A)
    B = jnp.where(edge_mask, -L, BIG)
    B = jnp.where(eye, 0.0, B)

    import math

    if n_iter is None:
        n_iter = max(1, math.ceil(math.log2(n)) + 1)
    Astar = _minplus_closure(A, n_iter)
    cross = _minplus(_minplus(Astar, B), Astar)

    U_ro = jnp.asarray(U_ro, dtype=L.dtype)
    Astar_ro = _minplus(Astar, U_ro)  # (..., M, no) reduced->side uppers
    Aor = jnp.swapaxes(Astar_ro, -1, -2)
    B_ro = jnp.where(L_ro > 0, -L_ro, BIG)
    B_oo = -jnp.asarray(D_oo, dtype=L.dtype)
    T1 = _minplus(_minplus(Astar, B_ro), Aor)
    T3 = _minplus(_minplus(Astar_ro, B_oo), Aor)
    cross = jnp.minimum(cross, jnp.minimum(T1, jnp.swapaxes(T1, -1, -2)))
    cross = jnp.minimum(cross, T3)

    ub = jnp.where(eye, 0.0, Astar)
    lb = jnp.where(eye, 0.0, jnp.maximum(0.0, -cross))
    return lb, ub


# ---------------------------------------------------------------------------
# Alignment / normalization
# ---------------------------------------------------------------------------

def best_fit_transform(A, B):
    """Least-squares rigid transform mapping points A onto B (geometry.py:60-100).

    Note: like the reference, the det<0 reflection case is deliberately NOT
    corrected (geometry.py:93-97) - solution extraction depends on this.

    Returns (R, t) with B ~= R @ A + t, batched over leading dims.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    ca = jnp.mean(A, axis=-2, keepdims=True)
    cb = jnp.mean(B, axis=-2, keepdims=True)
    H = jnp.einsum("...ni,...nj->...ij", A - ca, B - cb)
    U, _, Vt = jnp.linalg.svd(H)
    R = jnp.einsum("...ji,...kj->...ik", Vt, U)  # Vt^T @ U^T
    t = cb[..., 0, :] - jnp.einsum("...ij,...j->...i", R, ca[..., 0, :])
    return R, t


def procrustes_align(X, Y):
    """Rigidly align point set X onto Y; returns transformed X."""
    R, t = best_fit_transform(X, Y)
    return jnp.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]


def normalize_positions(Y):
    """Center and rotate points into their principal axes (dgp.py:233-242)."""
    Y = jnp.asarray(Y)
    Yc = Y - jnp.mean(Y, axis=-2, keepdims=True)
    C = jnp.einsum("...ni,...nj->...ij", Yc, Yc)
    _, v = jnp.linalg.eigh(C)
    return Yc @ v
