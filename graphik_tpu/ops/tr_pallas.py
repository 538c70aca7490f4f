"""Fused Pallas kernel (Triton route): the ENTIRE Riemannian trust-region solve.

The XLA formulation of the batched TR solver (solvers/riemannian.py) is a
vmapped `lax.while_loop` (outer TR) around a nested `lax.while_loop` (tCG).
Each tCG step is ~40 small HLO ops over (B, N, d) tensors with N ~ 16, and on
XLA:GPU every loop trip costs kernel launches plus a device-to-host copy of
the loop predicate, so the solve is bound by launches and syncs rather than
by the SMs. This kernel runs the complete outer-TR + truncated-CG loop for a
block of TB instances inside one Triton program: the state stays in
registers for the whole solve, and one launch replaces thousands.

Algorithm parity: trust_region.py:112-599 in the reference (outer loop,
Steihaug-Toint tCG, rho regularization, radius updates) and the quotient
manifold projection of fixed_rank_psd_sym.py:91-113 - reduced here from the
reference's 9x9 unrolled solve to a 3x3 SPD solve by exploiting that the
Lyapunov solution Om is antisymmetric (see solvers/riemannian.manifold_proj).

Cost convention matches ops/edge.py (= solvers/costs.py): the per-edge
squared-residual sum with the reference's 1/2-consistent gradient scaling;
all backends are parity-tested against each other.

Layout of one program (a block of TB instances; instances on the last axis,
every dimension a power of two, zero padding N -> Np, E -> Ep, B -> Bp):
    C      (Ep, Np)   signed incidence
    Ct     (Np, Ep)   its transpose
    par    (Ep, 8)    [omega, psi_L, psi_U, L_mask, U_mask, 0, 0, 0]
    dg     (Ep, TB)   per-instance squared goal distances on edges
    Y_k    (Np, TB)   one array per coordinate k < d (Triton has no value
                      slicing or general concatenate, so coordinates are
                      separate values, refs and loop carries)

Anchored hinges (node vs constant point, the obstacle reduction) are
streamed from memory in chunks of _ANCHOR_CHUNK rows that all belong to one
node: `asel` (Np, Cp) holds each chunk's node one-hot column and `apar`
(8 * RC, Cp) its rows' [psi_L, psi_U, L_mask, U_mask, center_0..d-1]. The
Hessian of the anchor terms is block-diagonal over nodes, so once per outer
iteration the chunks fold into per-node d x d blocks (stored as (Np, TB)
planes) and every Hessian-vector product applies them elementwise; the
anchor rows never sit in registers across tCG steps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from graphik_tpu.ops.edge import EdgeProblem

# tCG stop reasons (trust_region.py:68-83); mirrored in solvers/riemannian.py
_NEGATIVE_CURVATURE = 0
_EXCEEDED_TR = 1
_MAX_INNER_ITER = 4

# Triton's dot needs every operand dimension >= 16, and every block
# dimension must be a power of two.
_MIN_DIM = 16
_ANCHOR_CHUNK = 32
# Block rule (see _choose_block), from H100 sweeps (PERF.md, "Kernel
# decisions"): each instance's loop-resident state is spread over enough
# threads that a thread holds at most ~160 of the 255 registers it may
# have (ur10 at ~132 per thread ran 2-3x faster than at ~264, which
# spills); the grid keeps at least one block per SM of an H100 (132); and
# blocks stay at 16 or 32 instances (64 measured slower). Shared memory is
# not the limit: a block stages only dot operands (Ep x TB f32, 8 KB at
# ur10 widths) of the 227 KB it may use.
_REGS_PER_THREAD = 160
_NUM_SMS = 132
_MAX_TILE = 32


def _pow2(n: int, lo: int = _MIN_DIM) -> int:
    return max(lo, 1 << (max(int(n), 1) - 1).bit_length())


def _dot(a, b):
    # HIGHEST = IEEE f32 FMAs in Triton; TF32 would cost the mm-level
    # accuracy the joint-space polish depends on.
    return jnp.dot(
        a, b,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def _rowsum(x):
    return jnp.sum(x, axis=0, keepdims=True)  # (R, TB) -> (1, TB)


def _inner(a, b):
    """Per-instance inner product of two coordinate tuples -> (1, TB)."""
    out = _rowsum(a[0] * b[0])
    for ak, bk in zip(a[1:], b[1:]):
        out = out + _rowsum(ak * bk)
    return out


def _where(c, a, b):
    return tuple(jnp.where(c, ak, bk) for ak, bk in zip(a, b))


def _axpy(alpha, x, y):
    """alpha * x + y over coordinate tuples."""
    return tuple(alpha * xk + yk for xk, yk in zip(x, y))


def _sym_pairs(d):
    return [(k, l) for k in range(d) for l in range(k, d)]


def _tr_kernel(
    c_ref, ct_ref, par_ref, dg_ref, *refs,
    d: int, maxiter: int, maxinner: int, mingradnorm: float,
    kappa: float, theta: float, rho_prime: float, rho_regularization: float,
    Delta_bar: float, Delta0: float, mininner: int, n_chunks: int,
    plateau_every: int, plateau_rtol: float, plateau_atol: float,
    res_tol: float,
):
    f32 = jnp.float32
    has_anchors = n_chunks > 0
    if has_anchors:
        asel_ref, apar_ref, *refs = refs
    y0_refs = refs[:d]
    act_ref = refs[d]
    yout_refs = refs[d + 1:2 * d + 1]
    stats_ref = refs[2 * d + 1]

    C = c_ref[...]        # (Ep, Np)
    Ct = ct_ref[...]      # (Np, Ep)
    om = par_ref[:, 0:1]
    psiL = par_ref[:, 1:2]
    psiU = par_ref[:, 2:3]
    Lm = par_ref[:, 3:4]
    Um = par_ref[:, 4:5]
    dg = dg_ref[...]      # (Ep, TB)
    active = act_ref[...] > 0.0   # (1, TB)
    Y0 = tuple(r[...] for r in y0_refs)
    TB = dg.shape[1]
    eps = float(np.finfo(np.float32).eps)
    pairs = _sym_pairs(d)

    def edge_diffs(Y):
        return [_dot(C, Yk) for Yk in Y]

    def cost_terms(dY):
        dist = dY[0] * dY[0]
        for k in range(1, d):
            dist = dist + dY[k] * dY[k]
        s0 = om * (dg - dist)
        e1 = Lm * jnp.maximum(psiL - dist, 0.0)
        e2 = Um * jnp.maximum(dist - psiU, 0.0)
        return s0, e1, e2

    if res_tol > 0.0:
        # Per-instance scale floor for the relative-residual stop: the mean
        # equality-edge squared length (solvers/costs.residual_max).
        eq_cnt = jnp.maximum(jnp.sum(om), 1.0)
        r_floor = _rowsum(om * dg) / eq_cnt  # (1, TB)

    def anchor_chunk(c, Y):
        """Rows of anchor chunk c: node one-hot, per-row diffs and hinges."""
        sel = asel_ref[:, pl.ds(c, 1)]  # (Np, 1)

        def col(i):
            return apar_ref[pl.ds(i * _ANCHOR_CHUNK, _ANCHOR_CHUNK),
                            pl.ds(c, 1)]  # (RC, 1)

        adY = [_rowsum(sel * Y[k]) - col(4 + k) for k in range(d)]
        adist = adY[0] * adY[0]
        for k in range(1, d):
            adist = adist + adY[k] * adY[k]
        a1 = col(2) * jnp.maximum(col(0) - adist, 0.0)
        a2 = col(3) * jnp.maximum(adist - col(1), 0.0)
        return sel, adY, a1, a2, col

    def cost_and_grad(Y):
        """f (1, TB), grad (d x (Np, TB)), rmax (1, TB) - edge convention
        (ops/edge.py); rmax is 0 when the residual stop is disabled."""
        dY = edge_diffs(Y)
        s0, e1, e2 = cost_terms(dY)
        f = _rowsum(s0 * s0 + e1 * e1 + e2 * e2)
        s = s0 + e1 - e2
        g = tuple(-2.0 * _dot(Ct, s * dYk) for dYk in dY)
        if res_tol > 0.0:
            r = jnp.abs(s0) / jnp.maximum(dg, r_floor)
            r = jnp.maximum(r, e1 / jnp.maximum(psiL, r_floor))
            r = jnp.maximum(r, e2 / jnp.maximum(psiU, r_floor))
            rmax = jnp.max(r, axis=0, keepdims=True)
        else:
            rmax = jnp.zeros_like(f)
        if has_anchors:
            def body(c, carry):
                f, rmax, g = carry
                sel, adY, a1, a2, col = anchor_chunk(c, Y)
                f = f + _rowsum(a1 * a1 + a2 * a2)
                sa = a1 - a2
                g = tuple(g[k] - 2.0 * sel * _rowsum(sa * adY[k])
                          for k in range(d))
                if res_tol > 0.0:
                    ra = jnp.maximum(a1 / jnp.maximum(col(0), r_floor),
                                     a2 / jnp.maximum(col(1), r_floor))
                    rmax = jnp.maximum(rmax, jnp.max(ra, axis=0,
                                                     keepdims=True))
                return f, rmax, g

            f, rmax, g = jax.lax.fori_loop(0, n_chunks, body, (f, rmax, g))
        return f, g, rmax

    def gram_scalars(Y):
        """Unique entries of X = Y^T Y as (1, TB) rows: x11,x22,x33,x12,x13,x23."""
        out = [_rowsum(Y[i] * Y[i]) for i in range(d)]
        for i in range(d):
            for j in range(i + 1, d):
                out.append(_rowsum(Y[i] * Y[j]))
        return out

    def chol3(m11, m12, m13, m22, m23, m33):
        """Unrolled 3x3 Cholesky over instance rows."""
        l11 = jnp.sqrt(jnp.maximum(m11, 1e-30))
        l21 = m12 / l11
        l31 = m13 / l11
        l22 = jnp.sqrt(jnp.maximum(m22 - l21 * l21, 1e-30))
        l32 = (m23 - l31 * l21) / l22
        l33 = jnp.sqrt(jnp.maximum(m33 - l31 * l31 - l32 * l32, 1e-30))
        return l11, l21, l31, l22, l32, l33

    def chol3_solve(L, b1, b2, b3):
        l11, l21, l31, l22, l32, l33 = L
        y1 = b1 / l11
        y2 = (b2 - l21 * y1) / l22
        y3 = (b3 - l31 * y1 - l32 * y2) / l33
        x3 = y3 / l33
        x2 = (y2 - l32 * x3) / l22
        x1 = (y1 - l21 * x2 - l31 * x3) / l11
        return x1, x2, x3

    def proj_factors(Y):
        """Per-outer-iteration factorization of the reduced Lyapunov system."""
        if d == 2:
            x11, x22, x12 = gram_scalars(Y)
            reg = 10.0 * eps * (x11 + x22 + 1e-30)
            return (x11 + x22 + reg,)
        x11, x22, x33, x12, x13, x23 = gram_scalars(Y)
        reg = 10.0 * eps * (x11 + x22 + x33 + 1e-30)
        # M = [[x11+x22, x23, -x13], [x23, x11+x33, x12], [-x13, x12, x22+x33]]
        return chol3(
            x11 + x22 + reg, x23, -x13, x11 + x33 + reg, x12, x22 + x33 + reg
        )

    def proj(Y, H, fac):
        """Horizontal projection H - Y Om; Om antisymmetric from the
        Lyapunov system (solvers/riemannian.manifold_proj)."""
        if d == 2:
            a = _rowsum(Y[0] * H[1] - H[0] * Y[1]) / fac[0]
            return (H[0] + a * Y[1], H[1] - a * Y[0])
        c12 = _rowsum(Y[0] * H[1] - H[0] * Y[1])
        c13 = _rowsum(Y[0] * H[2] - H[0] * Y[2])
        c23 = _rowsum(Y[1] * H[2] - H[1] * Y[2])
        a, b, c = chol3_solve(fac, c12, c13, c23)
        # Om = [[0, a, b], [-a, 0, c], [-b, -c, 0]]; P = H - Y Om
        return (
            H[0] + a * Y[1] + b * Y[2],
            H[1] - a * Y[0] + c * Y[2],
            H[2] - b * Y[0] - c * Y[1],
        )

    def make_hvp(Y):
        """Riemannian Hessian-vector product at fixed Y (precomputed terms)."""
        dY = edge_diffs(Y)
        s0, e1, e2 = cost_terms(dY)
        s = s0 + e1 - e2
        m = om + Lm * (e1 > 0).astype(f32) + Um * (e2 > 0).astype(f32)
        fac = proj_factors(Y)
        if has_anchors:
            # Per-node anchor Hessian blocks: S[u] = sum of (a1 - a2) and
            # Q_kl[u] = sum of m_a adY_k adY_l over node u's anchor rows.
            def body(c, carry):
                S, Q = carry
                sel, adY, a1, a2, col = anchor_chunk(c, Y)
                ma = (col(2) * (a1 > 0).astype(f32)
                      + col(3) * (a2 > 0).astype(f32))
                S = S + sel * _rowsum(a1 - a2)
                Q = tuple(Q[i] + sel * _rowsum(ma * adY[k] * adY[l])
                          for i, (k, l) in enumerate(pairs))
                return S, Q

            zero = jnp.zeros_like(Y[0])
            S, Q = jax.lax.fori_loop(
                0, n_chunks, body, (zero, tuple(zero for _ in pairs)))
            Qkl = {}
            for i, (k, l) in enumerate(pairs):
                Qkl[k, l] = Qkl[l, k] = Q[i]

        def hvp(Z):
            dZ = edge_diffs(Z)
            dD = dY[0] * dZ[0]
            for k in range(1, d):
                dD = dD + dY[k] * dZ[k]
            mdD = m * (2.0 * dD)
            H = [2.0 * _dot(Ct, mdD * dY[k] - s * dZ[k]) for k in range(d)]
            if has_anchors:
                for k in range(d):
                    qz = Qkl[k, 0] * Z[0]
                    for l in range(1, d):
                        qz = qz + Qkl[k, l] * Z[l]
                    H[k] = H[k] + 2.0 * (2.0 * qz - S * Z[k])
            return proj(Y, H, fac)

        return hvp

    # ---------------- truncated CG (trust_region.py:436-599) ----------------
    def any_live(done):
        """True while some instance of the block is not done."""
        return jnp.max(jnp.where(done, 0, 1)) > 0

    def tcg(hvp, grad, Delta, outer_done):
        r0 = grad
        r_r0 = _inner(r0, r0)
        norm_r0 = jnp.sqrt(r_r0)
        pow_r0 = norm_r0 if theta == 1.0 else norm_r0 ** theta
        target = norm_r0 * jnp.minimum(pow_r0, kappa)

        zero_v = tuple(jnp.zeros_like(g) for g in grad)
        row0 = jnp.zeros((1, TB), f32)
        init = (
            jnp.zeros((), jnp.int32),                   # j
            zero_v,                                     # eta
            zero_v,                                     # Heta
            r0,                                         # r
            tuple(-g for g in r0),                      # delta
            row0,                                       # e_Pe
            row0,                                       # e_Pd
            r_r0,                                       # d_Pd
            r_r0,                                       # z_r
            jnp.full((1, TB), float(_MAX_INNER_ITER), f32),  # stop
            outer_done,                                 # tdone
            row0,                                       # steps taken
        )

        def cond(st):
            j, tdone = st[0], st[10]
            return (j < maxinner) & any_live(tdone)

        def body(st):
            (j, eta, Heta, r, delta, e_Pe, e_Pd, d_Pd, z_r, stop, tdone,
             nsteps) = st
            upd = ~tdone
            Hdelta = hvp(delta)
            d_Hd = _inner(delta, Hdelta)
            alpha = z_r / d_Hd
            e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd

            Dsq = Delta * Delta
            hit_boundary = (
                (d_Hd <= 0.0)
                | (e_Pe_new >= Dsq)
                | ~jnp.isfinite(alpha)
                | ~jnp.isfinite(e_Pe_new)
            )
            disc = jnp.maximum(e_Pd * e_Pd + d_Pd * (Dsq - e_Pe), 0.0)
            tau = (-e_Pd + jnp.sqrt(disc)) / d_Pd
            eta_b = _axpy(tau, delta, eta)
            Heta_b = _axpy(tau, Hdelta, Heta)
            stop_b = jnp.where(
                d_Hd <= 0.0,
                float(_NEGATIVE_CURVATURE),
                float(_EXCEEDED_TR),
            )

            new_eta = _axpy(alpha, delta, eta)
            new_Heta = _axpy(alpha, Hdelta, Heta)
            r_new = _axpy(alpha, Hdelta, r)
            r_r = _inner(r_new, r_new)
            norm_r = jnp.sqrt(r_r)
            reached = (j >= mininner) & (norm_r <= target)

            beta = r_r / z_r
            delta_new = tuple(beta * dk - rk for dk, rk in zip(delta, r_new))
            e_Pd_new = beta * (e_Pd + alpha * d_Pd)
            d_Pd_new = r_r + beta * beta * d_Pd

            take_boundary = upd & hit_boundary
            take_target = upd & (~hit_boundary) & reached

            eta_out = _where(upd, _where(take_boundary, eta_b, new_eta), eta)
            Heta_out = _where(
                upd, _where(take_boundary, Heta_b, new_Heta), Heta)

            done_now = take_boundary | take_target
            stop_out = jnp.where(
                take_boundary, stop_b, jnp.where(take_target, 2.0, stop)
            )
            tdone_new = tdone | done_now
            cont = upd & ~done_now

            return (
                j + 1,
                eta_out,
                Heta_out,
                _where(cont, r_new, r),
                _where(cont, delta_new, delta),
                jnp.where(cont, e_Pe_new, e_Pe),
                jnp.where(cont, e_Pd_new, e_Pd),
                jnp.where(cont, d_Pd_new, d_Pd),
                jnp.where(cont, r_r, z_r),
                stop_out,
                tdone_new,
                nsteps + upd.astype(f32),
            )

        out = jax.lax.while_loop(cond, body, init)
        eta, Heta, stop, nsteps = out[1], out[2], out[9], out[11]
        return eta, Heta, stop, nsteps

    # ---------------- outer TR loop (trust_region.py:112-434) --------------
    fx0, g0, rmax0 = cost_and_grad(Y0)
    norm_g0 = jnp.sqrt(_inner(g0, g0))
    done0 = (~active) | (norm_g0 < mingradnorm)
    if res_tol > 0.0:
        done0 = done0 | (rmax0 < res_tol)
    row0 = jnp.zeros((1, TB), f32)

    carry0 = (
        jnp.zeros((), jnp.int32),          # k (global)
        Y0,
        fx0,
        g0,
        norm_g0,
        jnp.full((1, TB), Delta0, f32),    # Delta
        done0,                             # done
        row0,                              # iters (per instance)
        row0,                              # num_inner (per instance)
        fx0,                               # fx_ref (plateau checkpoint)
        rmax0,                             # max relative residual
    )

    def ocond(st):
        k, done = st[0], st[6]
        return (k < maxiter) & any_live(done)

    def obody(st):
        (k, Y, fx, grad, norm_grad, Delta, done, iters, ninner, fx_ref,
         rmax) = st
        upd = ~done
        hvp = make_hvp(Y)
        eta, Heta, stop, nsteps = tcg(hvp, grad, Delta, done)
        stop_neg = stop == float(_NEGATIVE_CURVATURE)
        stop_tr = stop == float(_EXCEEDED_TR)

        Y_prop = tuple(yk + ek for yk, ek in zip(Y, eta))
        fx_prop, g_prop, rmax_prop = cost_and_grad(Y_prop)

        rho_reg = jnp.maximum(1.0, jnp.abs(fx)) * eps * rho_regularization
        rhonum = fx - fx_prop + rho_reg
        rhoden = -_inner(grad, eta) - 0.5 * _inner(eta, Heta) + rho_reg
        model_decreased = rhoden >= 0.0
        rho = rhonum / rhoden

        shrink = (rho < 0.25) | (~model_decreased) | jnp.isnan(rho)
        grow = (~shrink) & (rho > 0.75) & (stop_neg | stop_tr)
        Delta_new = jnp.where(
            shrink,
            Delta / 4.0,
            jnp.where(grow, jnp.minimum(2.0 * Delta, Delta_bar), Delta),
        )

        take = upd & model_decreased & (rho > rho_prime)
        Y_new = _where(take, Y_prop, Y)
        fx_new = jnp.where(take, fx_prop, fx)
        g_new = _where(take, g_prop, grad)
        norm_g_new = jnp.where(
            take, jnp.sqrt(_inner(g_prop, g_prop)), norm_grad
        )
        Delta_out = jnp.where(upd, Delta_new, Delta)

        done_new = done | (upd & (norm_g_new < mingradnorm))
        rmax_new = rmax
        if res_tol > 0.0:
            # Feasibility-aware stop: the accepted iterate already satisfies
            # every edge to ~res_tol/2 of its length - inside the GN polish
            # basin, so further TR iterations buy nothing.
            rmax_new = jnp.where(take, rmax_prop, rmax)
            done_new = done_new | (upd & (rmax_new < res_tol))
        fx_ref_new = fx_ref
        if plateau_every:
            # Cost-plateau stop (see TRParams.plateau_every): checked on the
            # global iteration counter so every live instance compares its
            # cost against the checkpoint from plateau_every iterations ago.
            at_check = (k + 1) % plateau_every == 0
            stalled = (fx_ref - fx_new) <= (
                plateau_rtol * fx_new + plateau_atol
            )
            done_new = done_new | (upd & stalled & at_check)
            fx_ref_new = jnp.where(at_check, fx_new, fx_ref)
        return (
            k + 1,
            Y_new,
            fx_new,
            g_new,
            norm_g_new,
            Delta_out,
            done_new,
            iters + upd.astype(f32),
            ninner + jnp.where(upd, nsteps, 0.0),
            fx_ref_new,
            rmax_new,
        )

    (_, Y, fx, _, norm_grad, Delta, _, iters, ninner, _,
     _) = jax.lax.while_loop(ocond, obody, carry0)

    for r, Yk in zip(yout_refs, Y):
        r[...] = Yk
    for i, row in enumerate((fx, norm_grad, iters, ninner, Delta)):
        stats_ref[i:i + 1, :] = row


def _state_floats(Np: int, Ep: int, d: int, has_anchors: bool) -> int:
    """Loop-resident f32 values per instance: the hvp's edge terms
    (dY, s, m) and its temporaries (dZ, dD), ~10 coordinate tuples (Y,
    grad, the tCG vectors and hvp outputs) and the per-node anchor Hessian
    blocks."""
    n = (2 * d + 3) * Ep + 10 * d * Np
    if has_anchors:
        n += (d * (d + 1) // 2 + 1) * Np
    return n


def _warps(tile: int, per_inst: int) -> int:
    """Warps (a power of two in [4, 16]) that keep a thread's share of the
    block's state within _REGS_PER_THREAD."""
    need = -(-tile * per_inst // (32 * _REGS_PER_THREAD))
    return min(16, max(4, _pow2(need, lo=1)))


def _choose_block(B: int, Np: int, Ep: int, d: int,
                  has_anchors: bool) -> tuple[int, int]:
    """(instances per program, warps): 32 instances while that still gives
    every SM a block, else 16; warps from the register rule."""
    tile = _MAX_TILE if -(-B // _MAX_TILE) >= _NUM_SMS else _MIN_DIM
    return tile, _warps(tile, _state_floats(Np, Ep, d, has_anchors))


def _anchor_chunks(ep: EdgeProblem, Np: int, d: int):
    """Chunked anchor layout: (asel (Np, Cp), apar (8 * RC, Cp), n_chunks).

    Each chunk holds up to RC rows of one node; padding rows have zero masks.
    """
    RC = _ANCHOR_CHUNK
    node = np.argmax(ep.aP, axis=1)
    chunks = []  # (node, row indices)
    for u in np.unique(node):
        rows = np.nonzero(node == u)[0]
        for s in range(0, len(rows), RC):
            chunks.append((u, rows[s:s + RC]))
    n_chunks = len(chunks)
    Cp = _pow2(n_chunks, lo=1)
    asel = np.zeros((Np, Cp), np.float32)
    apar = np.zeros((8 * RC, Cp), np.float32)
    fields = [ep.apsi_L, ep.apsi_U, ep.aL_mask, ep.aU_mask] + [
        ep.acenters[:, k] for k in range(d)
    ]
    for c, (u, rows) in enumerate(chunks):
        asel[u, c] = 1.0
        for i, v in enumerate(fields):
            apar[i * RC:i * RC + len(rows), c] = v[rows]
    return asel, apar, n_chunks


def solve_tr_pallas(
    ep: EdgeProblem,
    Y0,
    dgoal_e,
    *,
    maxiter: int = 3000,
    maxinner: int | None = None,
    mingradnorm: float | None = None,
    kappa: float = 0.1,
    theta: float = 1.0,
    rho_prime: float = 0.1,
    rho_regularization: float = 1e3,
    Delta_bar: float | None = None,
    Delta0: float | None = None,
    mininner: int = 1,
    plateau_every: int = 0,
    plateau_rtol: float = 0.0,
    plateau_atol: float = 0.0,
    res_tol: float = 0.0,
    tile: int | None = None,
    interpret: bool = False,
):
    """Run the full batched TR solve in one Pallas kernel (Triton route).

    Y0: (B, N, d) float initial points; dgoal_e: (B, E) squared goal
    distances on the compiled edge set (EdgeProblem.edge_values).
    tile: instances per program (a power of two >= 16); None = the block
    rule of _choose_block. interpret=True runs the kernel in the
    Pallas interpreter (tests on a machine without a GPU); otherwise the
    kernel compiles for the GPU and any other platform is an error.
    Returns dict(Y (B, N, d) f32, cost, gradnorm, iterations, num_inner).
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the fused TR kernel compiles only for the GPU (default backend "
            f"is {jax.default_backend()!r}); use backend='edge' or 'dense'"
        )
    B, N, d = Y0.shape
    E = ep.E
    Np = _pow2(N)
    Ep = _pow2(E)
    has_anchors = ep.A > 0
    if maxinner is None:
        maxinner = d * N
    if mingradnorm is None:
        mingradnorm = 2e-6
    if Delta_bar is None:
        Delta_bar = 10.0 + d
    if Delta0 is None:
        Delta0 = Delta_bar / 8.0
    if tile is None:
        tile, num_warps = _choose_block(B, Np, Ep, d, has_anchors)
    elif tile < _MIN_DIM or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two >= 16, got {tile}")
    else:
        num_warps = _warps(tile, _state_floats(Np, Ep, d, has_anchors))
    Bp = -(-B // tile) * tile

    # (B, N, d) -> d x (Np, Bp), zero-padded
    Yp = jnp.pad(Y0.astype(jnp.float32), ((0, Bp - B), (0, Np - N), (0, 0)))
    Ys = [Yp[:, :, k].T for k in range(d)]
    act = jnp.pad(jnp.ones((1, B), jnp.float32), ((0, 0), (0, Bp - B)))
    dgf = jnp.pad(dgoal_e[:, :E].astype(jnp.float32),
                  ((0, Bp - B), (0, Ep - E))).T

    C = np.zeros((Ep, Np), np.float32)
    C[:E, :N] = ep.C[:E]
    par = np.zeros((Ep, 8), np.float32)
    for i, v in enumerate((ep.omega, ep.psi_L, ep.psi_U, ep.L_mask,
                           ep.U_mask)):
        par[:E, i] = v[:E]

    n_chunks = 0
    inputs = [jnp.asarray(C), jnp.asarray(C.T), jnp.asarray(par), dgf]
    fixed = lambda b: (0, 0)
    lanes = lambda b: (0, b)
    in_specs = [
        pl.BlockSpec((Ep, Np), fixed),
        pl.BlockSpec((Np, Ep), fixed),
        pl.BlockSpec((Ep, 8), fixed),
        pl.BlockSpec((Ep, tile), lanes),
    ]
    if has_anchors:
        asel, apar, n_chunks = _anchor_chunks(ep, Np, d)
        inputs += [jnp.asarray(asel), jnp.asarray(apar)]
        in_specs += [pl.BlockSpec(asel.shape, fixed),
                     pl.BlockSpec(apar.shape, fixed)]
    inputs += Ys + [act]
    in_specs += [pl.BlockSpec((Np, tile), lanes)] * d
    in_specs += [pl.BlockSpec((1, tile), lanes)]

    kern = partial(
        _tr_kernel,
        d=d, maxiter=int(maxiter), maxinner=int(maxinner),
        mingradnorm=float(mingradnorm), kappa=float(kappa),
        theta=float(theta), rho_prime=float(rho_prime),
        rho_regularization=float(rho_regularization),
        Delta_bar=float(Delta_bar), Delta0=float(Delta0),
        mininner=int(mininner), n_chunks=n_chunks,
        plateau_every=int(plateau_every), plateau_rtol=float(plateau_rtol),
        plateau_atol=float(plateau_atol), res_tol=float(res_tol),
    )
    *Yout, stats = pl.pallas_call(
        kern,
        grid=(Bp // tile,),
        in_specs=in_specs,
        out_specs=[pl.BlockSpec((Np, tile), lanes)] * d
        + [pl.BlockSpec((8, tile), lanes)],
        out_shape=[jax.ShapeDtypeStruct((Np, Bp), jnp.float32)] * d
        + [jax.ShapeDtypeStruct((8, Bp), jnp.float32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="tr_solve",
    )(*inputs)
    Y = jnp.stack([Yk[:N, :B].T for Yk in Yout], axis=-1)
    return {
        "Y": Y,
        "cost": stats[0, :B],
        "gradnorm": stats[1, :B],
        "iterations": stats[2, :B].astype(jnp.int32),
        "num_inner": stats[3, :B].astype(jnp.int32),
    }
