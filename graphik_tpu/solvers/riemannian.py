"""Batched Riemannian trust-region solver over the rank-d PSD quotient manifold.

Reimplementation of the reference's vendored Manopt TrustRegions +
truncated CG (/root/reference/graphik/solvers/trust_region.py:112-599) and the
PSDFixedRank quotient manifold (utils/manifolds/fixed_rank_psd_sym.py:23-138):

* A point is Y in R^{N x d} representing the Gram matrix Y Y^T.
* The horizontal projection solves the Lyapunov system
  (Y^T Y) Om + Om (Y^T Y) = Y^T Z - Z^T Y (fixed_rank_psd_sym.py:91-113);
  exploiting antisymmetry of Om it reduces to a d(d-1)/2-unknown SPD
  solve (3x3 for d=3) instead of the reference's unrolled 9x9 system -
  batched and branch-free (see manifold_proj).
* Retraction is Y + U (fixed_rank_psd_sym.py:137-138); the Euclidean
  gradient is already horizontal for this cost, matching the reference's
  egrad2rgrad identity (fixed_rank_psd_sym.py:123-124).

Three backends share the algorithm (resolve_backend picks one):
* "pallas" (float32 default): the ENTIRE outer-TR + truncated-CG loop fused
  into one Pallas kernel on the Triton route over the compiled edge form
  (ops/tr_pallas.py) - the production hot path; GPU only.
* "dense"/"edge": per-instance `lax.while_loop`s vmapped over the batch
  (converged instances freeze their state so radius/rho bookkeeping stays
  exact per instance, SURVEY.md section 7.3) - "dense" is the float64
  default and the oracle path; both run on any platform.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphik_tpu.ops.linalg import spd_solve_unrolled
from graphik_tpu.solvers import costs
from graphik_tpu.utils import dgp

# tCG stop reasons (trust_region.py:68-83)
NEGATIVE_CURVATURE = 0
EXCEEDED_TR = 1
REACHED_TARGET_LINEAR = 2
REACHED_TARGET_SUPERLINEAR = 3
MAX_INNER_ITER = 4
MODEL_INCREASED = 5


@dataclasses.dataclass(frozen=True)
class TRParams:
    """Trust-region hyperparameters (defaults: riemannian_solver.py:44-50,
    trust_region.py:85-122)."""

    maxiter: int = 3000
    mingradnorm: Optional[float] = None  # default by dtype in solve()
    theta: float = 1.0
    kappa: float = 0.1
    rho_prime: float = 0.1
    rho_regularization: float = 1e3
    maxinner: Optional[int] = None  # default: N*d (CG dimension)
    mininner: int = 1
    Delta_bar: Optional[float] = None  # default: typicaldist = 10 + d
    Delta0: Optional[float] = None  # default: Delta_bar / 8
    # The reference's model-increase guard exists for nonlinear Hessian
    # approximations (trust_region.py:476-489); our Hessian-vector product is
    # exact and linear, where tCG decreases the model monotonically in exact
    # arithmetic. In float32 the guard trips on rounding noise and stalls
    # convergence, so it is off by default.
    check_model_decrease: bool = False
    # Per-lane cost-plateau stop: every `plateau_every` outer iterations a
    # lane stops if its cost decreased by less than
    # plateau_rtol * cost + plateau_atol over the window. The reference's
    # absolute gradnorm test (trust_region.py:413-422) is unreachable in
    # float32 (mingradnorm 2e-6 almost never fires), so without this every
    # lane burns the full maxiter budget. Default 0 = DISABLED so
    # TRParams() matches the reference's stopping semantics
    # (maxiter/gradnorm only); the tuned production preset
    # (TRParams.production, used by bench.py and the serving examples)
    # opts into 16 explicitly.
    plateau_every: int = 0
    plateau_rtol: float = 1e-4
    plateau_atol: float = 0.0
    # Feasibility-aware stop: a lane stops as soon as its max RELATIVE edge
    # residual (costs.residual_max - |D_goal - D| over the edge's squared
    # length, hinge violations over their bound, floored at the mean edge
    # scale) drops below res_tol. For an edge of length L this bounds the
    # endpoint error by ~res_tol L / 2, i.e. the lane is already inside the
    # GN polish basin; burning more TR iterations there buys nothing the
    # polish doesn't provide. 0 disables (reference-faithful: the reference
    # only stops on gradnorm, trust_region.py:413-422).
    res_tol: float = 0.0
    # Fused-kernel block override (instances per Triton program, a power of
    # two >= 16); None = the block rule in ops/tr_pallas._choose_block.
    tile: Optional[int] = None
    # Solver backend: "dense" = masked (N, N) linear algebra
    # (solvers/costs.py); "edge" = compiled incidence-matrix edge list
    # (ops/edge.py) - same math, E-compressed data movement (the
    # reference's numba edge-kernel analogue); "pallas" = the full TR+tCG
    # loop fused into one Pallas kernel on the Triton route
    # (ops/tr_pallas.py), float32 on the GPU only. None = by dtype:
    # "pallas" for float32, "dense" otherwise (resolve_backend).
    backend: Optional[str] = None

    @classmethod
    def production(cls, **overrides) -> "TRParams":
        """Tuned serving preset: reference-divergent knobs, opted into
        EXPLICITLY (library defaults stay reference-faithful).

        plateau_every=16: per-lane cost-plateau stop - in float32 the
        reference's mingradnorm test almost never fires, so without a
        plateau stop every lane burns the full maxiter budget (the
        operating point in bench.py layers maxiter/maxinner on top).
        """
        base = dict(plateau_every=16)
        base.update(overrides)
        return cls(**base)


@dataclasses.dataclass(frozen=True)
class CGParams:
    """Riemannian conjugate-gradient hyperparameters.

    The reference's alternative solver (riemannian_solver.py:51-59):
    pymanopt's ConjugateGradient with beta_type=BetaTypes[3] (Hager-Zhang),
    an adaptive Armijo line search, Powell restart on loss of conjugacy
    (orth_value), and gradnorm/stepsize stopping. Defaults mirror the
    reference's construction (mingradnorm 1e-9, minstepsize 1e-10,
    orth_value 1e10 - effectively never restarts).
    """

    maxiter: int = 1000
    mingradnorm: Optional[float] = None  # default by dtype in solve_cg()
    minstepsize: float = 1e-10
    orth_value: float = 1e10
    # line search (pymanopt LineSearchAdaptive defaults)
    ls_contraction: float = 0.5
    ls_optimism: float = 2.0
    ls_suff_decr: float = 1e-4
    ls_maxiter: int = 25
    ls_initial: float = 1.0
    # per-lane cost-plateau stop (see TRParams.plateau_every); CG lanes in
    # float32 stall at the gradient noise floor the same way TR lanes do.
    # Default 0 = reference-faithful stopping; production() opts into 16.
    plateau_every: int = 0
    plateau_rtol: float = 1e-4
    plateau_atol: float = 0.0
    backend: str = "dense"  # "dense" | "edge" cost evaluation

    @classmethod
    def production(cls, **overrides) -> "CGParams":
        """Tuned serving preset; see TRParams.production."""
        base = dict(plateau_every=16)
        base.update(overrides)
        return cls(**base)


def manifold_proj(Y, Z):
    """Horizontal-space projection on the PSDFixedRank quotient.

    Solves the Lyapunov system X Om + Om X = C with X = Y^T Y,
    C = Y^T Z - Z^T Y, and returns Z - Y Om.

    The reference unrolls the full d^2 x d^2 vectorized system
    (fixed_rank_psd_sym.py:91-113). That is wasteful: C is antisymmetric and
    X is SPD, so the solution Om is antisymmetric (if Om solves the system,
    -Om^T solves it too, and the Lyapunov operator is invertible). Restricted
    to antisymmetric matrices the system has only d(d-1)/2 unknowns - a
    single scalar for d=2 and a 3x3 SPD solve for d=3. A small Tikhonov
    shift keeps it finite when Y is (nearly) rank deficient, where the
    quotient geometry degenerates (fixed_rank_psd_sym.py:40-43).
    """
    d = Y.shape[-1]
    X = jnp.einsum("...ki,...kj->...ij", Y, Y)
    C = jnp.einsum("...ki,...kj->...ij", Y, Z) - jnp.einsum(
        "...ki,...kj->...ij", Z, Y
    )
    reg = 10 * jnp.finfo(Y.dtype).eps * (
        jnp.trace(X, axis1=-2, axis2=-1) + 1e-30
    )
    if d == 2:
        a = C[..., 0, 1] / (X[..., 0, 0] + X[..., 1, 1] + reg)
        zero = jnp.zeros_like(a)
        Om = jnp.stack(
            [
                jnp.stack([zero, a], axis=-1),
                jnp.stack([-a, zero], axis=-1),
            ],
            axis=-2,
        )
    elif d == 3:
        # Basis (a, b, c) -> Om = [[0, a, b], [-a, 0, c], [-b, -c, 0]].
        # (X Om + Om X) upper entries give the symmetric positive-definite
        # reduced system M (a, b, c)^T = (C12, C13, C23)^T with
        # M = [[X11+X22, X23, -X13], [X23, X11+X33, X12], [-X13, X12, X22+X33]].
        x11, x22, x33 = X[..., 0, 0], X[..., 1, 1], X[..., 2, 2]
        x12, x13, x23 = X[..., 0, 1], X[..., 0, 2], X[..., 1, 2]
        M = jnp.stack(
            [
                jnp.stack([x11 + x22 + reg, x23, -x13], axis=-1),
                jnp.stack([x23, x11 + x33 + reg, x12], axis=-1),
                jnp.stack([-x13, x12, x22 + x33 + reg], axis=-1),
            ],
            axis=-2,
        )
        rhs = jnp.stack(
            [C[..., 0, 1], C[..., 0, 2], C[..., 1, 2]], axis=-1
        )
        abc = spd_solve_unrolled(M, rhs)
        a, b, c = abc[..., 0], abc[..., 1], abc[..., 2]
        zero = jnp.zeros_like(a)
        Om = jnp.stack(
            [
                jnp.stack([zero, a, b], axis=-1),
                jnp.stack([-a, zero, c], axis=-1),
                jnp.stack([-b, -c, zero], axis=-1),
            ],
            axis=-2,
        )
    else:
        eye = jnp.eye(d, dtype=Y.dtype)
        # A[(ij),(kl)] = X[i,k] delta[j,l] + delta[i,k] X[j,l]  (row-major vec)
        A = (
            X[..., :, None, :, None] * eye[None, :, None, :]
            + eye[:, None, :, None] * X[..., None, :, None, :]
        ).reshape(X.shape[:-2] + (d * d, d * d))
        A = A + reg[..., None, None] * jnp.eye(d * d, dtype=Y.dtype)
        vec_om = spd_solve_unrolled(A, C.reshape(C.shape[:-2] + (d * d,)))
        Om = vec_om.reshape(C.shape)
    return Z - Y @ Om


def resolve_backend(backend: Optional[str], dtype) -> str:
    """The TR backend for `dtype`: TRParams.backend, or the dtype default
    (float32 -> the fused "pallas" kernel, anything else -> "dense")."""
    dtype = jnp.dtype(dtype)
    if backend is None:
        return "pallas" if dtype == jnp.float32 else "dense"
    if backend not in ("dense", "edge", "pallas"):
        raise ValueError(f"unknown TR backend {backend!r}")
    if backend == "pallas" and dtype != jnp.float32:
        raise ValueError(
            f"backend='pallas' is float32 only, got {dtype}; use 'dense' "
            "or 'edge' (or backend=None) for other dtypes"
        )
    return backend


def _inner(a, b):
    return jnp.sum(a * b)


class _TCGState(NamedTuple):
    j: jnp.ndarray
    eta: jnp.ndarray
    Heta: jnp.ndarray
    r: jnp.ndarray
    delta_dir: jnp.ndarray
    e_Pe: jnp.ndarray
    e_Pd: jnp.ndarray
    d_Pd: jnp.ndarray
    z_r: jnp.ndarray
    model_value: jnp.ndarray
    stop: jnp.ndarray
    done: jnp.ndarray


def _tcg(hess_fn, grad, Delta, p: TRParams, maxinner: int):
    """Steihaug-Toint truncated CG (trust_region.py:436-599), single instance.

    Returns (eta, Heta, num_inner, stop_reason).
    """
    dt = grad.dtype
    zero = jnp.zeros_like(grad)
    r0 = grad
    r_r0 = _inner(r0, r0)
    norm_r0 = jnp.sqrt(r_r0)

    init = _TCGState(
        j=jnp.zeros((), jnp.int32),
        eta=zero,
        Heta=zero,
        r=r0,
        delta_dir=-r0,
        e_Pe=jnp.zeros((), dt),
        e_Pd=jnp.zeros((), dt),
        d_Pd=r_r0,
        z_r=r_r0,
        model_value=jnp.zeros((), dt),
        stop=jnp.full((), MAX_INNER_ITER, jnp.int32),
        done=jnp.zeros((), bool),
    )

    def cond(s: _TCGState):
        return (~s.done) & (s.j < maxinner)

    def body(s: _TCGState):
        Hdelta = hess_fn(s.delta_dir)
        d_Hd = _inner(s.delta_dir, Hdelta)
        alpha = s.z_r / d_Hd
        e_Pe_new = s.e_Pe + 2.0 * alpha * s.e_Pd + alpha**2 * s.d_Pd

        # negative curvature / TR boundary exit (trust_region.py:509-535).
        # Non-finite alpha/e_Pe (curvature underflow on frozen or degenerate
        # lanes) also routes to the boundary exit so NaNs never enter eta.
        hit_boundary = (
            (d_Hd <= 0)
            | (e_Pe_new >= Delta**2)
            | ~jnp.isfinite(alpha)
            | ~jnp.isfinite(e_Pe_new)
        )
        disc = jnp.maximum(s.e_Pd**2 + s.d_Pd * (Delta**2 - s.e_Pe), 0.0)
        tau = (-s.e_Pd + jnp.sqrt(disc)) / s.d_Pd
        eta_b = s.eta + tau * s.delta_dir
        Heta_b = s.Heta + tau * Hdelta
        stop_b = jnp.where(d_Hd <= 0, NEGATIVE_CURVATURE, EXCEEDED_TR)

        # interior step
        new_eta = s.eta + alpha * s.delta_dir
        new_Heta = s.Heta + alpha * Hdelta
        if p.check_model_decrease:
            new_model = _inner(new_eta, grad) + 0.5 * _inner(new_eta, new_Heta)
            # NaN model counts as increased -> exit with previous finite eta
            model_increased = ~(new_model < s.model_value)
        else:
            new_model = s.model_value
            model_increased = jnp.zeros((), bool)

        r_new = s.r + alpha * Hdelta
        r_r = _inner(r_new, r_new)
        norm_r = jnp.sqrt(r_r)
        target = norm_r0 * jnp.minimum(norm_r0**p.theta, p.kappa)
        reached = (s.j >= p.mininner) & (norm_r <= target)
        stop_target = jnp.where(
            p.kappa < norm_r0**p.theta,
            REACHED_TARGET_LINEAR,
            REACHED_TARGET_SUPERLINEAR,
        )

        beta = r_r / s.z_r
        delta_new = -r_new + beta * s.delta_dir
        e_Pd_new = beta * (s.e_Pd + alpha * s.d_Pd)
        d_Pd_new = r_r + beta**2 * s.d_Pd

        # resolution order: boundary exit > model increase > target > continue
        take_boundary = hit_boundary
        take_modelinc = (~hit_boundary) & model_increased
        take_target = (~hit_boundary) & (~model_increased) & reached

        def sel(b, x, y):
            return jnp.where(b, x, y)

        eta_out = sel(take_boundary, eta_b, new_eta)
        Heta_out = sel(take_boundary, Heta_b, new_Heta)
        # model-increase exit returns the *previous* eta (trust_region.py:552-554)
        eta_out = sel(take_modelinc, s.eta, eta_out)
        Heta_out = sel(take_modelinc, s.Heta, Heta_out)

        done = take_boundary | take_modelinc | take_target
        stop = jnp.where(
            take_boundary,
            stop_b,
            jnp.where(
                take_modelinc,
                MODEL_INCREASED,
                jnp.where(take_target, stop_target, s.stop),
            ),
        )

        return _TCGState(
            j=s.j + 1,
            eta=eta_out,
            Heta=Heta_out,
            r=sel(done, s.r, r_new),
            delta_dir=sel(done, s.delta_dir, delta_new),
            e_Pe=sel(done, s.e_Pe, e_Pe_new),
            e_Pd=sel(done, s.e_Pd, e_Pd_new),
            d_Pd=sel(done, s.d_Pd, d_Pd_new),
            z_r=sel(done, s.z_r, r_r),
            model_value=sel(done, s.model_value, new_model),
            stop=stop,
            done=done,
        )

    out = jax.lax.while_loop(cond, body, init)
    return out.eta, out.Heta, out.j, out.stop


class _TRState(NamedTuple):
    k: jnp.ndarray
    Y: jnp.ndarray
    fx: jnp.ndarray
    grad: jnp.ndarray
    norm_grad: jnp.ndarray
    Delta: jnp.ndarray
    done: jnp.ndarray
    num_inner_total: jnp.ndarray
    fx_ref: jnp.ndarray  # cost at the last plateau checkpoint
    rmax: jnp.ndarray  # max relative residual at the current iterate


def _solve_single(Y0, cost_fn, grad_fn, hess_fn, p: TRParams, maxinner: int,
                  resmax_fn=None):
    """One TR solve (trust_region.py:112-434); to be vmapped."""
    dt = Y0.dtype
    eps = jnp.finfo(dt).eps

    Delta_bar = p.Delta_bar if p.Delta_bar is not None else 10.0 + Y0.shape[-1]
    Delta0 = p.Delta0 if p.Delta0 is not None else Delta_bar / 8.0
    mingradnorm = p.mingradnorm
    if mingradnorm is None:
        mingradnorm = 0.5e-9 if dt == jnp.float64 else 2e-6
    use_res = p.res_tol > 0.0 and resmax_fn is not None

    fx0 = cost_fn(Y0)
    g0 = grad_fn(Y0)
    rmax0 = resmax_fn(Y0) if use_res else jnp.full((), jnp.inf, dt)
    init = _TRState(
        k=jnp.zeros((), jnp.int32),
        Y=Y0,
        fx=fx0,
        grad=g0,
        norm_grad=jnp.sqrt(_inner(g0, g0)),
        Delta=jnp.full((), Delta0, dt),
        done=jnp.logical_and(use_res, rmax0 < p.res_tol),
        num_inner_total=jnp.zeros((), jnp.int32),
        fx_ref=fx0,
        rmax=rmax0,
    )

    def cond(s: _TRState):
        return ~s.done

    def body(s: _TRState):
        eta, Heta, numit, stop_inner = _tcg(
            lambda v: hess_fn(s.Y, v), s.grad, s.Delta, p, maxinner
        )

        Y_prop = s.Y + eta  # retraction (fixed_rank_psd_sym.py:137-138)
        fx_prop = cost_fn(Y_prop)

        # rho with the Conn-Gould-Toint regularization heuristic
        # (trust_region.py:287-289)
        rho_reg = jnp.maximum(1.0, jnp.abs(s.fx)) * eps * p.rho_regularization
        rhonum = s.fx - fx_prop + rho_reg
        rhoden = -_inner(s.grad, eta) - 0.5 * _inner(eta, Heta) + rho_reg
        model_decreased = rhoden >= 0
        rho = rhonum / rhoden

        shrink = (rho < 0.25) | (~model_decreased) | jnp.isnan(rho)
        grow = (
            (~shrink)
            & (rho > 0.75)
            & ((stop_inner == NEGATIVE_CURVATURE) | (stop_inner == EXCEEDED_TR))
        )
        Delta_new = jnp.where(
            shrink,
            s.Delta / 4.0,
            jnp.where(grow, jnp.minimum(2.0 * s.Delta, Delta_bar), s.Delta),
        )

        accept = model_decreased & (rho > p.rho_prime)
        Y_new = jnp.where(accept, Y_prop, s.Y)
        fx_new = jnp.where(accept, fx_prop, s.fx)
        g_new = jnp.where(accept, grad_fn(Y_prop), s.grad)
        norm_grad_new = jnp.where(
            accept, jnp.sqrt(jnp.sum(g_new * g_new)), s.norm_grad
        )

        k_new = s.k + 1
        done = (norm_grad_new < mingradnorm) | (k_new >= p.maxiter)
        rmax_new = s.rmax
        if use_res:
            rmax_new = jnp.where(accept, resmax_fn(Y_prop), s.rmax)
            done = done | (rmax_new < p.res_tol)
        fx_ref_new = s.fx_ref
        if p.plateau_every:
            at_check = (k_new % p.plateau_every) == 0
            stalled = (s.fx_ref - fx_new) <= (
                p.plateau_rtol * fx_new + p.plateau_atol
            )
            done = done | (at_check & stalled)
            fx_ref_new = jnp.where(at_check, fx_new, s.fx_ref)

        return _TRState(
            k=k_new,
            Y=Y_new,
            fx=fx_new,
            grad=g_new,
            norm_grad=norm_grad_new,
            Delta=Delta_new,
            done=done,
            num_inner_total=s.num_inner_total + numit,
            fx_ref=fx_ref_new,
            rmax=rmax_new,
        )

    out = jax.lax.while_loop(cond, body, init)
    return {
        "Y": out.Y,
        "cost": out.fx,
        "gradnorm": out.norm_grad,
        "iterations": out.k,
        "num_inner": out.num_inner_total,
    }


def solve(
    Y0,
    D_goal,
    omega,
    psi_L=None,
    psi_U=None,
    params: TRParams = TRParams(),
    anchors=None,
):
    """Batched Riemannian TR solve of the EDM completion problem.

    Parameters
    ----------
    Y0 : (..., N, d) initial points (batch leading dims).
    D_goal : (..., N, N) squared goal distances (batched or unbatched).
    omega : (N, N) equality mask (static).
    psi_L, psi_U : (N, N) squared bound matrices or None for no limits.
    anchors : optional anchored-hinge spec (host numpy dict from
        ProblemStructure.reduced_spec()) - hinge terms between selected
        rows of Y and constant points (the obstacle reduction).

    Returns dict of per-instance results (Y, cost, gradnorm, iterations).
    """
    Y0 = jnp.asarray(Y0)
    dt = Y0.dtype
    N, d = Y0.shape[-2], Y0.shape[-1]
    # omega/psi are template constants (host arrays), never traced values:
    # the edge/pallas backends compile them into a static EdgeProblem.
    omega_host = np.asarray(omega, np.float64)
    if psi_L is None:
        psi_L_host = np.zeros((N, N))
        psi_U_host = np.zeros((N, N))
    else:
        psi_L_host = np.asarray(psi_L, np.float64)
        psi_U_host = np.asarray(psi_U, np.float64)
    omega = jnp.asarray(omega_host, dtype=dt)
    psi_L = jnp.asarray(psi_L_host, dtype=dt)
    psi_U = jnp.asarray(psi_U_host, dtype=dt)
    L_mask, U_mask = costs.make_masks(omega, psi_L, psi_U)

    maxinner = params.maxinner if params.maxinner is not None else N * d

    batch = Y0.shape[:-2]
    D_goal = jnp.broadcast_to(jnp.asarray(D_goal, dtype=dt), batch + (N, N))

    backend = resolve_backend(params.backend, dt)
    if backend == "pallas":
        from graphik_tpu.ops import edge as edge_ops
        from graphik_tpu.ops.tr_pallas import solve_tr_pallas

        ep = edge_ops.build_edge_problem(
            omega_host, psi_L_host, psi_U_host, dim=d, anchors=anchors
        )
        Yf = Y0.reshape((-1, N, d))
        dg_e = ep.edge_values(D_goal.reshape((-1, N, N)))
        mingrad = params.mingradnorm if params.mingradnorm is not None else 2e-6
        out = solve_tr_pallas(
            ep, Yf, dg_e,
            maxiter=params.maxiter,
            maxinner=maxinner,
            mingradnorm=mingrad,
            kappa=params.kappa,
            theta=params.theta,
            rho_prime=params.rho_prime,
            rho_regularization=params.rho_regularization,
            Delta_bar=params.Delta_bar,
            Delta0=params.Delta0,
            mininner=params.mininner,
            plateau_every=params.plateau_every,
            plateau_rtol=params.plateau_rtol,
            plateau_atol=params.plateau_atol,
            res_tol=params.res_tol,
            tile=params.tile,
        )
        return {
            k: v.reshape(batch + v.shape[1:]).astype(dt)
            if k == "Y"
            else v.reshape(batch + v.shape[1:])
            for k, v in out.items()
        }

    if backend == "edge":
        from graphik_tpu.ops import edge as edge_ops

        ep = edge_ops.build_edge_problem(
            omega_host, psi_L_host, psi_U_host, dim=d, anchors=anchors
        )

        def one(Y0_i, D_goal_i):
            dg_e = ep.edge_values(D_goal_i)
            cost_fn = lambda Y: edge_ops.cost(ep, Y, dg_e)
            grad_fn = lambda Y: edge_ops.egrad(ep, Y, dg_e)
            hess_fn = lambda Y, v: manifold_proj(
                Y, edge_ops.ehess(ep, Y, v, dg_e)
            )
            resmax_fn = lambda Y: edge_ops.residual_max(ep, Y, dg_e)
            return _solve_single(Y0_i, cost_fn, grad_fn, hess_fn, params,
                                 maxinner, resmax_fn=resmax_fn)
    else:
        def one(Y0_i, D_goal_i):
            cost_fn = lambda Y: costs.cost(
                Y, D_goal_i, omega, psi_L, psi_U, L_mask, U_mask, anchors
            )
            grad_fn = lambda Y: costs.egrad(
                Y, D_goal_i, omega, psi_L, psi_U, L_mask, U_mask, anchors
            )
            hess_fn = lambda Y, v: manifold_proj(
                Y, costs.ehess(Y, v, D_goal_i, omega, psi_L, psi_U, L_mask,
                               U_mask, anchors)
            )
            resmax_fn = lambda Y: costs.residual_max(
                Y, D_goal_i, omega, psi_L, psi_U, L_mask, U_mask, anchors
            )
            return _solve_single(Y0_i, cost_fn, grad_fn, hess_fn, params,
                                 maxinner, resmax_fn=resmax_fn)

    fn = one
    for _ in range(len(batch)):
        fn = jax.vmap(fn)
    return fn(Y0, D_goal)


class _CGState(NamedTuple):
    k: jnp.ndarray
    Y: jnp.ndarray
    fx: jnp.ndarray
    grad: jnp.ndarray
    norm_grad: jnp.ndarray
    d: jnp.ndarray          # search direction
    oldalpha: jnp.ndarray   # adaptive line-search memory (<=0: unset)
    stepsize: jnp.ndarray
    done: jnp.ndarray
    fx_ref: jnp.ndarray


def _solve_cg_single(Y0, cost_fn, grad_fn, p: CGParams):
    """One Riemannian CG solve (pymanopt ConjugateGradient semantics with
    Hager-Zhang beta, the reference's beta_type=BetaTypes[3]); to be
    vmapped. Transport on the PSDFixedRank quotient is horizontal
    projection at the new point (the total space is Euclidean)."""
    dt = Y0.dtype
    mingradnorm = p.mingradnorm
    if mingradnorm is None:
        mingradnorm = 1e-9 if dt == jnp.float64 else 2e-6

    fx0 = cost_fn(Y0)
    g0 = grad_fn(Y0)
    init = _CGState(
        k=jnp.zeros((), jnp.int32),
        Y=Y0,
        fx=fx0,
        grad=g0,
        norm_grad=jnp.sqrt(_inner(g0, g0)),
        d=-g0,
        oldalpha=jnp.zeros((), dt),
        stepsize=jnp.full((), jnp.inf, dt),
        done=jnp.zeros((), bool),
        fx_ref=fx0,
    )

    def linesearch(Y, fx, d, df0, oldalpha):
        """Adaptive Armijo backtracking (pymanopt LineSearchAdaptive)."""
        norm_d = jnp.sqrt(_inner(d, d))
        alpha0 = jnp.where(
            oldalpha > 0, oldalpha,
            p.ls_initial / jnp.maximum(norm_d, jnp.finfo(dt).tiny),
        )

        def ls_cond(s):
            alpha, newf, evals = s
            return (newf > fx + p.ls_suff_decr * alpha * df0) & (
                evals <= p.ls_maxiter
            )

        def ls_body(s):
            alpha, _, evals = s
            alpha = alpha * p.ls_contraction
            return (alpha, cost_fn(Y + alpha * d), evals + 1)

        alpha, newf, evals = jax.lax.while_loop(
            ls_cond, ls_body, (alpha0, cost_fn(Y + alpha0 * d),
                               jnp.ones((), jnp.int32))
        )
        # no decrease at all -> reject the step (alpha = 0)
        alpha = jnp.where(newf > fx, jnp.zeros((), dt), alpha)
        newf = jnp.where(alpha > 0, newf, fx)
        # memory: one contraction keeps alpha, otherwise be optimistic
        oldalpha_new = jnp.where(evals == 2, alpha, p.ls_optimism * alpha)
        return alpha, newf, alpha * norm_d, oldalpha_new

    def body(s: _CGState):
        df0 = _inner(s.grad, s.d)
        # not a descent direction -> steepest-descent restart
        # (conjugate_gradient.py descent check)
        bad = df0 >= 0
        d = jnp.where(bad, -s.grad, s.d)
        df0 = jnp.where(bad, -s.norm_grad**2, df0)

        alpha, newf, stepsize, oldalpha = linesearch(
            s.Y, s.fx, d, df0, s.oldalpha
        )
        Y_new = s.Y + alpha * d
        g_new = grad_fn(Y_new)
        norm_g_new = jnp.sqrt(_inner(g_new, g_new))

        # Powell restart when successive gradients lose orthogonality
        orth = jnp.abs(_inner(g_new, s.grad)) / jnp.maximum(
            norm_g_new**2, jnp.finfo(dt).tiny
        )
        powell = orth >= p.orth_value

        # transport = horizontal projection at the new point
        d_t = manifold_proj(Y_new, d)
        g_t = manifold_proj(Y_new, s.grad)
        diff = g_new - g_t
        deno = _inner(diff, d_t)
        safe_deno = jnp.where(jnp.abs(deno) > 0, deno, 1.0)
        numo = _inner(diff, g_new) - 2.0 * _inner(diff, diff) * _inner(
            d_t, g_new
        ) / safe_deno
        beta = numo / safe_deno
        # Hager-Zhang robustness floor
        norm_dt = jnp.sqrt(_inner(d_t, d_t))
        eta_hz = -1.0 / jnp.maximum(
            norm_dt * jnp.minimum(jnp.asarray(0.01, dt), s.norm_grad),
            jnp.finfo(dt).tiny,
        )
        beta = jnp.maximum(beta, eta_hz)
        beta = jnp.where((jnp.abs(deno) > 0) & ~powell, beta, 0.0)
        d_new = -g_new + beta * d_t

        k_new = s.k + 1
        done = (
            (norm_g_new < mingradnorm)
            | (stepsize < p.minstepsize)
            | (k_new >= p.maxiter)
        )
        fx_ref_new = s.fx_ref
        if p.plateau_every:
            at_check = (k_new % p.plateau_every) == 0
            stalled = (s.fx_ref - newf) <= (
                p.plateau_rtol * newf + p.plateau_atol
            )
            done = done | (at_check & stalled)
            fx_ref_new = jnp.where(at_check, newf, s.fx_ref)

        return _CGState(
            k=k_new,
            Y=Y_new,
            fx=newf,
            grad=g_new,
            norm_grad=norm_g_new,
            d=d_new,
            oldalpha=oldalpha,
            stepsize=stepsize,
            done=done,
            fx_ref=fx_ref_new,
        )

    out = jax.lax.while_loop(lambda s: ~s.done, body, init)
    return {
        "Y": out.Y,
        "cost": out.fx,
        "gradnorm": out.norm_grad,
        "iterations": out.k,
        "num_inner": jnp.zeros((), jnp.int32),
    }


def solve_cg(
    Y0,
    D_goal,
    omega,
    psi_L=None,
    psi_U=None,
    params: CGParams = CGParams(),
    anchors=None,
):
    """Batched Riemannian conjugate-gradient solve (the reference's
    params["solver"] == "ConjugateGradient" option,
    riemannian_solver.py:51-59). Same problem data contract as `solve`.
    """
    Y0 = jnp.asarray(Y0)
    dt = Y0.dtype
    N, d = Y0.shape[-2], Y0.shape[-1]
    omega_host = np.asarray(omega, np.float64)
    if psi_L is None:
        psi_L_host = np.zeros((N, N))
        psi_U_host = np.zeros((N, N))
    else:
        psi_L_host = np.asarray(psi_L, np.float64)
        psi_U_host = np.asarray(psi_U, np.float64)
    omega = jnp.asarray(omega_host, dtype=dt)
    psi_L = jnp.asarray(psi_L_host, dtype=dt)
    psi_U = jnp.asarray(psi_U_host, dtype=dt)
    L_mask, U_mask = costs.make_masks(omega, psi_L, psi_U)

    batch = Y0.shape[:-2]
    D_goal = jnp.broadcast_to(jnp.asarray(D_goal, dtype=dt), batch + (N, N))

    if params.backend == "edge":
        from graphik_tpu.ops import edge as edge_ops

        ep = edge_ops.build_edge_problem(
            omega_host, psi_L_host, psi_U_host, dim=d, anchors=anchors
        )

        def one(Y0_i, D_goal_i):
            dg_e = ep.edge_values(D_goal_i)
            cost_fn = lambda Y: edge_ops.cost(ep, Y, dg_e)
            grad_fn = lambda Y: edge_ops.egrad(ep, Y, dg_e)
            return _solve_cg_single(Y0_i, cost_fn, grad_fn, params)
    else:
        def one(Y0_i, D_goal_i):
            cost_fn = lambda Y: costs.cost(
                Y, D_goal_i, omega, psi_L, psi_U, L_mask, U_mask, anchors
            )
            grad_fn = lambda Y: costs.egrad(
                Y, D_goal_i, omega, psi_L, psi_U, L_mask, U_mask, anchors
            )
            return _solve_cg_single(Y0_i, cost_fn, grad_fn, params)

    fn = one
    for _ in range(len(batch)):
        fn = jax.vmap(fn)
    return fn(Y0, D_goal)


# MDS init used by the solver entry points (api, parallel.mesh): cuSOLVER
# eigh prepared ur10 faster than the subspace iteration on the H100, and
# compiled far faster (PERF.md, "Init decision").
DEFAULT_INIT = "eigh"


def generate_initialization(lb, ub, omega, dim, key=None, eigh_sweeps: int = 0,
                            method: str = DEFAULT_INIT, rank: int = 8,
                            subspace_iters: int = 8):
    """Deterministic (or sampled) MDS initialization from smoothed bounds.

    Mirrors RiemannianSolver.generate_initialization
    (riemannian_solver.py:67-75): D = (lb + 0.9 (ub - lb))^2 -> Gram -> MDS
    -> linear projection onto R^dim along dominant edge-scatter directions.

    method:
      "eigh": full decomposition, exact reference semantics.
      "subspace": rank-`rank` orthogonal-iteration MDS factor + dominant
      edge-scatter directions by the same iteration (ops/subspace.py) -
      ~10 rounds of batched matmuls instead of an eigendecomposition.
    eigh_sweeps ("eigh" only): 0 = exact `eigh`; >0 = that many fixed
    Jacobi sweeps (ops/jacobi.py).
    """
    D_rand = dgp.sample_distance_matrix(lb, ub, key=key)
    G = dgp.gram_from_distance_matrix(D_rand)
    if method == "subspace":
        from graphik_tpu.ops.subspace import factor_psd_topk

        rank = min(rank, G.shape[-1])
        X = factor_psd_topk(G, rank, subspace_iters)
        return dgp.linear_projection(X, omega, dim,
                                     subspace_iters=subspace_iters)
    if method != "eigh":
        raise ValueError(f"unknown init method {method!r}")
    X = dgp.mds(G, eps=1e-8, eigh_sweeps=eigh_sweeps)
    return dgp.linear_projection(X, omega, dim, eigh_sweeps=eigh_sweeps)
