"""Pose-graph Levenberg-Marquardt solver.

The ONE native back-end replacing the reference's four interchangeable
solvers (SURVEY §2.3): vendored SPA2d (`lesson6/lib/sparse_bundle_adjustment/
src/spa2d.cpp:425-609`), g2o, Ceres, and GTSAM adapters. Its surface mirrors
`karto::ScanSolver` (Mapper.h:825-891): AddNode / AddConstraint / Compute.

Residual model (identical to SpaSolver's Con2dP2 and Ceres's
pose_graph_2d_error_term.h:59-102):
    r_xy = R(θi)ᵀ (t_j − t_i) − ẑ_xy
    r_θ  = normalize(θ_j − θ_i − ẑ_θ)
weighted by the 3×3 information (precision) matrix Ω = covariance⁻¹
(spa_solver.cc:43-91 inverts the link covariance).

Design (SURVEY §7 stage 7): no sparse Cholesky on the device. Edges live in
fixed-capacity batched arrays; residuals/Jacobians are one batched einsum;
normal equations are assembled by scatter-add of 3×3 blocks. Two solve paths:
  * dense blocked Cholesky for small graphs (exact, one LAPACK/XLA solve)
  * block-Jacobi preconditioned CG with an edge-wise matvec for large graphs
    (the bpcg.h analogue) — the matvec is gather + batched 3×3 matmul +
    segment-sum, which shards cleanly over devices (edges axis + psum).
The LM accept/reject loop reproduces doSPA: λ×0.5 on improvement, λ×laminc
with laminc doubling on failure, stop on ‖δ‖² < 1e-16 (spa2d.cpp:531-582).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam.config import SolverConfig

# float32 products at full precision: on a GPU XLA may otherwise run them in
# TF32 (about 10 mantissa bits), which the LM's cost comparisons can see
_HI = jax.lax.Precision.HIGHEST

# CG steps fused per while_loop iteration (masked past tolerance): each
# device loop iteration has a fixed launch cost, which at 100 CG iterations
# per LM step can outweigh the small matvec itself
CG_UNROLL = 4


def _rot(th):
    c, s = jnp.cos(th), jnp.sin(th)
    return jnp.stack(
        [jnp.stack([c, -s], -1), jnp.stack([s, c], -1)], -2
    )  # (..., 2, 2)


def edge_residuals(poses, ei, ej, means):
    """(E, 3) residuals of the relative-pose constraints."""
    pi = poses[ei]
    pj = poses[ej]
    Rt = jnp.swapaxes(_rot(pi[:, 2]), -1, -2)
    dt = pj[:, :2] - pi[:, :2]
    rxy = jnp.einsum("eab,eb->ea", Rt, dt, precision=_HI) - means[:, :2]
    rth = pj[:, 2] - pi[:, 2] - means[:, 2]
    rth = jnp.arctan2(jnp.sin(rth), jnp.cos(rth))
    return jnp.concatenate([rxy, rth[:, None]], axis=-1)


def edge_jacobians(poses, ei, ej):
    """Analytic Jacobians (E,3,3)×2 wrt nodes i and j (Con2dP2 setJacobians
    semantics; same as pose_graph_2d_error_term.h)."""
    pi = poses[ei]
    pj = poses[ej]
    th = pi[:, 2]
    c, s = jnp.cos(th), jnp.sin(th)
    dt = pj[:, :2] - pi[:, :2]
    # dRᵀ/dθ · dt
    drx = -s * dt[:, 0] + c * dt[:, 1]
    dry = -c * dt[:, 0] - s * dt[:, 1]
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    Ji = jnp.stack(
        [
            jnp.stack([-c, -s, drx], -1),
            jnp.stack([s, -c, dry], -1),
            jnp.stack([zeros, zeros, -ones], -1),
        ],
        -2,
    )
    Jj = jnp.stack(
        [
            jnp.stack([c, s, zeros], -1),
            jnp.stack([-s, c, zeros], -1),
            jnp.stack([zeros, zeros, ones], -1),
        ],
        -2,
    )
    return Ji, Jj


def graph_cost(poses, ei, ej, means, infos, mask):
    r = edge_residuals(poses, ei, ej, means)
    w = mask.astype(poses.dtype)
    return jnp.sum(
        w * jnp.einsum("ea,eab,eb->e", r, infos, r, precision=_HI))


def inv3x3(A):
    """Closed-form batched 3×3 inverse (adjugate / determinant).

    The closed form works at any dtype (the f64 solver path uses it) and
    is cheaper than a batched LU for 3×3 blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / det
    row0 = jnp.stack([co_a, -(b * i - c * h), b * f - c * e], -1)
    row1 = jnp.stack([co_b, a * i - c * g, -(a * f - c * d)], -1)
    row2 = jnp.stack([co_c, -(a * h - b * g), a * e - b * d], -1)
    return jnp.stack([row0, row1, row2], -2) * inv_det[..., None, None]


# --- transposed (edges-along-lanes) forms -----------------------------------
# The (E,3,3)/(M,3) block layouts above put 3 in the minor dimension — every
# batched-tiny-matmul einsum and scatter is a tiny contraction. The _T forms
# keep EDGES in the minor dimension
# ((k, E)/(k, M) rows), express the 3×3 block algebra as ~200 fusable
# elementwise formulas, and turn gather/scatter into one-hot matmuls
# (exact: HIGHEST precision decomposes the f32 operand against an exactly
# representable 0/1 one-hot). Used by the single-device LM program below a
# node cap (the (M, E) one-hots are O(M·E) memory).


def _onehot_maps(ei, ej, M, dtype):
    """Gi/Gj (M, E): column e is one-hot at node ei[e]/ej[e]."""
    rows = jnp.arange(M, dtype=ei.dtype)[:, None]
    return (
        (ei[None, :] == rows).astype(dtype),
        (ej[None, :] == rows).astype(dtype),
    )


def _edge_terms_T(pT, Gi, Gj, meansT):
    """Shared per-edge rows: residuals r0/r1/r2 and the trig/Jacobian
    scalars (all (E,) lanes)."""
    pi = jax.lax.dot_general(pT, Gi, (((1,), (0,)), ((), ())), precision=_HI)
    pj = jax.lax.dot_general(pT, Gj, (((1,), (0,)), ((), ())), precision=_HI)
    c, s = jnp.cos(pi[2]), jnp.sin(pi[2])
    dx, dy = pj[0] - pi[0], pj[1] - pi[1]
    r0 = c * dx + s * dy - meansT[0]
    r1 = -s * dx + c * dy - meansT[1]
    rt = pj[2] - pi[2] - meansT[2]
    r2 = jnp.arctan2(jnp.sin(rt), jnp.cos(rt))
    drx = -s * dx + c * dy
    dry = -c * dx - s * dy
    return c, s, drx, dry, r0, r1, r2


def graph_cost_T(pT, Gi, Gj, meansT, W6):
    """rᵀΩr summed over edges; W6 = mask-weighted upper-triangle rows
    (6, E) of the information matrices."""
    _c, _s, _dx, _dy, r0, r1, r2 = _edge_terms_T(pT, Gi, Gj, meansT)
    q = (
        W6[0] * r0 * r0 + 2 * W6[1] * r0 * r1 + 2 * W6[2] * r0 * r2
        + W6[3] * r1 * r1 + 2 * W6[4] * r1 * r2 + W6[5] * r2 * r2
    )
    return jnp.sum(q)


def normal_equations_T(pT, Gi, Gj, meansT, W6):
    """Transposed normal equations: Hd (M,3,3), Hij (E,3,3), b (M,3) —
    same contract as normal_equations (sum order differs in low f32 bits)."""
    c, s, drx, dry, r0, r1, r2 = _edge_terms_T(pT, Gi, Gj, meansT)
    E = c.shape[0]
    M = Gi.shape[0]
    dt = pT.dtype
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    W00, W01, W02, W11, W12, W22 = W6

    def JtW(j0, j1, j2):
        return (
            j0 * W00 + j1 * W01 + j2 * W02,
            j0 * W01 + j1 * W11 + j2 * W12,
            j0 * W02 + j1 * W12 + j2 * W22,
        )

    # Ji columns: (-c, s, 0), (-s, -c, 0), (drx, dry, -1); Jj: (c, -s, 0),
    # (s, c, 0), (0, 0, 1) — edge_jacobians row forms, transposed
    JiW = [JtW(-c, s, z), JtW(-s, -c, z), JtW(drx, dry, -o)]
    JjW = [JtW(c, -s, z), JtW(s, c, z), JtW(z, z, o)]
    Jic = [(-c, s, z), (-s, -c, z), (drx, dry, -o)]
    Jjc = [(c, -s, z), (s, c, z), (z, z, o)]

    def block(JW, Jc):
        return jnp.stack(
            [
                JW[a][0] * Jc[b][0] + JW[a][1] * Jc[b][1]
                + JW[a][2] * Jc[b][2]
                for a in range(3)
                for b in range(3)
            ]
        )  # (9, E)

    Hii9 = block(JiW, Jic)
    Hjj9 = block(JjW, Jjc)
    Hij9 = block(JiW, Jjc)
    bi3 = jnp.stack(
        [JiW[a][0] * r0 + JiW[a][1] * r1 + JiW[a][2] * r2 for a in range(3)]
    )
    bj3 = jnp.stack(
        [JjW[a][0] * r0 + JjW[a][1] * r1 + JjW[a][2] * r2 for a in range(3)]
    )
    GiT, GjT = Gi.T, Gj.T
    Hd9 = (
        jax.lax.dot_general(Hii9, GiT, (((1,), (0,)), ((), ())),
                            precision=_HI)
        + jax.lax.dot_general(Hjj9, GjT, (((1,), (0,)), ((), ())),
                              precision=_HI)
    )  # (9, M)
    b3 = (
        jax.lax.dot_general(bi3, GiT, (((1,), (0,)), ((), ())),
                            precision=_HI)
        + jax.lax.dot_general(bj3, GjT, (((1,), (0,)), ((), ())),
                              precision=_HI)
    )  # (3, M)
    Hd = jnp.moveaxis(Hd9.reshape(3, 3, M), -1, 0).astype(dt)
    Hij = jnp.moveaxis(Hij9.reshape(3, 3, E), -1, 0).astype(dt)
    return Hd, Hij, b3.T


def normal_equations(poses, ei, ej, means, infos, mask, n_nodes_max):
    """Scatter-assembled blocks: H_ii/H_jj/H_ij and gradient b = Jᵀ Ω r.

    Returns (Hd (M,3,3) diagonal blocks, rows of off-diag contributions via
    (E,3,3) with their indices, b (M,3)). Kept in block form so both dense
    and CG paths can consume it.
    """
    r = edge_residuals(poses, ei, ej, means)
    Ji, Jj = edge_jacobians(poses, ei, ej)
    w = mask.astype(poses.dtype)
    wi = infos * w[:, None, None]
    JiW = jnp.einsum("eba,ebc->eac", Ji, wi, precision=_HI)  # Jiᵀ Ω
    JjW = jnp.einsum("eba,ebc->eac", Jj, wi, precision=_HI)
    Hii = jnp.einsum("eab,ebc->eac", JiW, Ji, precision=_HI)
    Hjj = jnp.einsum("eab,ebc->eac", JjW, Jj, precision=_HI)
    Hij = jnp.einsum("eab,ebc->eac", JiW, Jj, precision=_HI)
    bi = jnp.einsum("eab,eb->ea", JiW, r, precision=_HI)
    bj = jnp.einsum("eab,eb->ea", JjW, r, precision=_HI)

    Hd = jnp.zeros((n_nodes_max, 3, 3), poses.dtype)
    Hd = Hd.at[ei].add(Hii)
    Hd = Hd.at[ej].add(Hjj)
    b = jnp.zeros((n_nodes_max, 3), poses.dtype)
    b = b.at[ei].add(bi)
    b = b.at[ej].add(bj)
    return Hd, Hij, b


def assemble_dense(Hd, Hij, ei, ej):
    """Block form → full (M,3,M,3) system, NO damping / gauge handling.

    Kept separate from the solve so the distributed path can psum the
    assembled partials from per-device edge shards before finalizing."""
    M = Hd.shape[0]
    H = jnp.zeros((M, 3, M, 3), Hd.dtype)
    H = H.at[jnp.arange(M), :, jnp.arange(M), :].set(Hd)
    H = H.at[ei, :, ej, :].add(Hij)
    H = H.at[ej, :, ei, :].add(jnp.swapaxes(Hij, -1, -2))
    return H


def finalize_dense_solve(H, b, lam, free_mask):
    """Damp + gauge-fix an assembled (M,3,M,3) system, solve Hδ = −b.

    free_mask (M,): False rows are gauge-fixed (node 0, nFixed=1 in
    spa_solver.cc) — their rows/cols are identity/zero.
    LM damping is multiplicative on the block diagonal: diag *= (1+λ)
    (setupSys, spa2d.cpp:300-310)."""
    M = free_mask.shape[0]
    dt = H.dtype
    eye3 = jnp.eye(3, dtype=dt)
    Hd = H[jnp.arange(M), :, jnp.arange(M), :]
    Hd = Hd + 1e-12 * eye3  # keep unused nodes invertible
    Hd = Hd.at[:, jnp.arange(3), jnp.arange(3)].mul(1.0 + lam)
    H = H.at[jnp.arange(M), :, jnp.arange(M), :].set(Hd)

    fm = free_mask.astype(dt)
    H = H * fm[:, None, None, None] * fm[None, None, :, None]
    # fixed/unused nodes: identity diagonal so the solve stays well-posed
    H = H.at[jnp.arange(M), :, jnp.arange(M), :].add(
        (1.0 - fm)[:, None, None] * eye3
    )
    bb = b * fm[:, None]

    Hf = H.reshape(3 * M, 3 * M)
    delta = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(Hf), -bb.reshape(-1)
    )
    return delta.reshape(M, 3)


def dense_solve(Hd, Hij, ei, ej, b, lam, free_mask):
    """Assemble the full (3M, 3M) system and solve Hδ = −b by Cholesky."""
    return finalize_dense_solve(
        assemble_dense(Hd, Hij, ei, ej), b, lam, free_mask
    )


def cg_matvec(x, Hd_damped, Hij, ei, ej, free_mask, psum_axis=None):
    """y = H x with H in block form — the shardable edge-wise matvec.

    With ``psum_axis``, Hij/ei/ej are this device's edge shard: the
    off-diagonal contribution is psum'd over the mesh (Hd_damped, x and
    free_mask are replicated)."""
    fm = free_mask.astype(x.dtype)
    x = x * fm[:, None]
    xi = x[ei]
    xj = x[ej]
    y_off = jnp.zeros_like(x)
    y_off = y_off.at[ei].add(
        jnp.einsum("eab,eb->ea", Hij, xj, precision=_HI))
    y_off = y_off.at[ej].add(
        jnp.einsum("eba,eb->ea", Hij, xi, precision=_HI))
    if psum_axis is not None:
        y_off = jax.lax.psum(y_off, psum_axis)
    y = jnp.einsum("mab,mb->ma", Hd_damped, x, precision=_HI) + y_off
    y = y * fm[:, None] + x * (1.0 - fm[:, None])
    return y


def cg_solve(Hd, Hij, ei, ej, b, lam, free_mask, iters, tol,
             psum_axis=None, restarts=1):
    """Block-Jacobi preconditioned CG (the bpcg.h analogue).

    Runs at most ``iters`` steps, stopping early once the residual has
    dropped below ``tol`` relative to the RHS: ‖r‖² ≤ tol·‖b‖² (tol ≤ 0
    disables the early-out). Deviation from the reference: bpcg.h breaks
    on the Jacobi-PRECONDITIONED residual r·(M⁻¹r) relative to its initial
    value; with tol on a squared norm the effective relative tolerance
    here is √tol, looser — absorbed by the conservative 1e-10 default
    (PARITY.md deviation 8). With ``psum_axis`` the edge arrays are
    per-device shards (Hd/b must already be psum'd)."""
    dt = Hd.dtype
    eye3 = jnp.eye(3, dtype=dt)
    Hdd = Hd + 1e-12 * eye3
    Hdd = Hdd.at[:, jnp.arange(3), jnp.arange(3)].mul(1.0 + lam)
    fm = free_mask.astype(dt)
    Hdd_solve = Hdd * fm[:, None, None] + (1.0 - fm)[:, None, None] * eye3
    Minv = inv3x3(Hdd_solve)

    bb = -b * fm[:, None]
    x0 = jnp.zeros_like(bb)

    def mv(x):
        return cg_matvec(x, Hdd, Hij, ei, ej, free_mask, psum_axis)

    def precond(r):
        return jnp.einsum("mab,mb->ma", Minv, r, precision=_HI)

    stop2 = jnp.asarray(max(float(tol), 0.0), dt) * jnp.sum(bb * bb)

    def step(state):
        # masked CG step: once the residual is under tolerance the state
        # freezes, so CG_UNROLL steps per while iteration keep the exact
        # early-out semantics while paying the per-loop-iteration overhead
        # UNROLL× less often
        x, r, z, p, rz, it = state
        # gate on the iteration cap too: without it up to UNROLL-1 extra
        # live steps could run past `iters` between cond checks — with it
        # the docstring's "at most iters" holds
        live = (jnp.sum(r * r) > stop2) & (it < iters)
        lv = live.astype(dt)
        Ap = mv(p)
        pAp = jnp.sum(p * Ap)
        alpha = rz / jnp.where(pAp != 0.0, pAp, 1.0)
        x = x + lv * alpha * p
        r = jnp.where(live, r - alpha * Ap, r)
        z_new = precond(r)
        z = jnp.where(live, z_new, z)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(rz != 0.0, rz, 1.0)
        p = jnp.where(live, z + beta * p, p)
        rz = jnp.where(live, rz_new, rz)
        return (x, r, z, p, rz, it + live.astype(jnp.int32))

    def body(state):
        for _ in range(CG_UNROLL):
            state = step(state)
        return state

    def cond(state):
        _x, r, _z, _p, _rz, it = state
        return (it < iters) & (jnp.sum(r * r) > stop2)

    x = x0
    # restarted CG: recompute the TRUE residual and a fresh Krylov space
    # every `iters` steps. f32 CG loses conjugacy on large graphs — at 4k+
    # nodes a single long run stalls or degrades; restarts cap the drift.
    for _ in range(max(int(restarts), 1)):
        r0 = bb - mv(x)
        z0 = precond(r0)
        x, *_ = jax.lax.while_loop(
            cond, body, (x, r0, z0, z0, jnp.sum(r0 * z0), jnp.int32(0))
        )
    return x


def _sq_min_delta(convergence_delta: float, dtype) -> float:
    """cfg.convergence_delta with the f32 floor (see _lm_loop_program)."""
    if dtype == jnp.float64:
        return float(convergence_delta)
    return max(float(convergence_delta), 1e-8)


def mixed_schur_delta(
    schur_part, poses, ei, ej, means, infos, mask, lam, free_mask,
    pcg_iters: int = 100,
):
    """f64-exact LM delta via an f32 Schur factorization reused as the
    PCG preconditioner.

    The large non-bandable graphs need a DIRECT method (f32/f64 CG are
    algorithmically inadequate at chain condition ~1e6). So: assemble the
    normal equations in f64 (cheap, exact), factor the damped system ONCE
    per LM step in f32 (schur.schur_factor), and run a short f64 PCG whose
    preconditioner is that factor. The preconditioned system has condition
    ≈ 1 + κ·eps32, so a dozen iterations of f64 MATVECS (no f64 factorization at all)
    recover the f64-direct answer."""
    M = schur_part.n_nodes
    dt = poses.dtype
    Hd, Hij, b = normal_equations(poses, ei, ej, means, infos, mask, M)
    from tpu_slam.solver.schur import (
        _damped_diag, schur_apply, schur_factor)

    # jitter + damping via the SAME helper as the f32 schur_delta path —
    # the two Schur paths must optimize the identical damped system
    Hdd = _damped_diag(Hd, lam)
    fm = free_mask.astype(dt)

    # the PRECONDITIONER factors at a FLOORED damping: as LM converges
    # λ → 1e-9 and the system's f32 condition explodes — the f32 Cholesky
    # goes indefinite and its NaN deltas stall the accept/reject loop
    # (measured: LM stuck at ATE 1.19 on the outdoor graph vs 0.651 with
    # exact steps). The f64 operator keeps the TRUE λ, so PCG still
    # converges to the exact delta; the floored factor only costs a few
    # extra (cheap, matvec-only) iterations.
    lam32 = jnp.maximum(lam, 1e-5)
    Hdd32 = _damped_diag(Hd, lam32)
    fac = schur_factor(
        schur_part, Hdd32.astype(jnp.float32), Hij.astype(jnp.float32),
        free_mask,
    )

    def mv(x):
        return cg_matvec(x, Hdd, Hij, ei, ej, free_mask)

    def prec(r):
        return schur_apply(schur_part, fac, r, free_mask).astype(dt)

    bb = -b * fm[:, None]
    x = prec(bb)  # the f32 direct solve itself is the starting point
    r = bb - mv(x)
    z = prec(r)
    # residual-stopped PCG: near LM convergence (λ → 1e-9) the floored
    # factor mismatches the soft flat-valley modes by ~λ_floor/λ, and a
    # fixed dozen iterations leaves exactly those directions unsolved
    # (measured: the LM stalls at cost 2071 vs 2064 / ATE 1.17 vs 0.651).
    # Iterations are matvec+backsub only — orders cheaper than the
    # per-LM-step factorization — so the cap is generous.
    stop2 = jnp.asarray(1e-24, dt) * jnp.sum(bb * bb)

    def cond(state):
        _x, r, _z, _p, _rz, it = state
        return (it < pcg_iters) & (jnp.sum(r * r) > stop2)

    def step(state):
        x, r, z, p, rz, it = state
        Ap = mv(p)
        pAp = jnp.sum(p * Ap)
        alpha = rz / jnp.where(pAp != 0.0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.where(rz != 0.0, rz, 1.0)
        p = z + beta * p
        return (x, r, z, p, rz_new, it + 1)

    x, *_ = jax.lax.while_loop(
        cond, step, (x, r, z, z, jnp.sum(r * z), jnp.int32(0))
    )
    return x


def _host_direct_lm(poses, ei, ej, means, infos, mask, free,
                    iters, lam0, sq_min_delta):
    """f64 sparse-direct LM on the HOST — the non-bandable ill-conditioned
    regime.

    The offline mission's global graphs (chain + skip + loop edges, no
    band under RCM) have soft global-warp modes with eigenvalues ~1e8
    below the diagonal: exact Newton steps need f64 factorization. The
    mixed f32-factor/f64-PCG path either floors the damping (λ·diag ≫
    σ_soft → the LM crawls: cost 7.4 after 113 iterations against the f64
    optimum 4.45 on the loops-only outdoor graph) or caps out its PCG on
    the preconditioner mismatch in exactly those modes. This is the
    reference's own CSparse regime (spa2d.cpp:505): a low-FLOP irregular
    sparse factorization. The device keeps the FLOP-heavy paths
    (matching, the LM programs, distributed LM); this arm is the
    final-polish solver for the offline pipeline's irregular global
    graphs. A device f64 direct solve could replace it."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from tpu_slam import geometry_np as gnp

    p = poses.astype(np.float64).copy()
    M = p.shape[0]
    E = len(ei)
    w = mask.astype(np.float64)
    infw = infos.astype(np.float64) * w[:, None, None]
    fidx = np.nonzero(free)[0]
    col_of = -np.ones(M, np.int64)
    col_of[fidx] = np.arange(len(fidx))
    nf = len(fidx)

    def residuals(q):
        rel = gnp.compose(gnp.inverse(q[ei]), q[ej])
        r = rel - means
        r[:, 2] = np.arctan2(np.sin(r[:, 2]), np.cos(r[:, 2]))
        return r

    def cost(q):
        r = residuals(q)
        return float(np.einsum("ei,eij,ej->", r, infw, r))

    # static COO index pattern: 4 blocks of 3x3 per edge on free nodes
    bi = col_of[ei]
    bj = col_of[ej]
    r3 = np.arange(3)

    def block_idx(a, b):
        n = len(a)
        rows = np.broadcast_to(
            3 * a[:, None, None] + r3[None, :, None], (n, 3, 3))
        cols = np.broadcast_to(
            3 * b[:, None, None] + r3[None, None, :], (n, 3, 3))
        return rows, cols

    lam, laminc = float(lam0), 2.0
    c = cost(p)
    cost0 = c
    good = 0
    for _ in range(iters):
        r = residuals(p)
        ci, si = np.cos(p[ei, 2]), np.sin(p[ei, 2])
        dx = p[ej, 0] - p[ei, 0]
        dy = p[ej, 1] - p[ei, 1]
        Ji = np.zeros((E, 3, 3))
        Jj = np.zeros((E, 3, 3))
        Ji[:, 0, 0] = -ci
        Ji[:, 0, 1] = -si
        Ji[:, 0, 2] = -si * dx + ci * dy
        Ji[:, 1, 0] = si
        Ji[:, 1, 1] = -ci
        Ji[:, 1, 2] = -ci * dx - si * dy
        Ji[:, 2, 2] = -1.0
        Jj[:, 0, 0] = ci
        Jj[:, 0, 1] = si
        Jj[:, 1, 0] = -si
        Jj[:, 1, 1] = ci
        Jj[:, 2, 2] = 1.0
        JiW = np.einsum("eba,ebc->eac", Ji, infw)
        JjW = np.einsum("eba,ebc->eac", Jj, infw)
        Hii = np.einsum("eab,ebc->eac", JiW, Ji)
        Hjj = np.einsum("eab,ebc->eac", JjW, Jj)
        Hij = np.einsum("eab,ebc->eac", JiW, Jj)
        g = np.zeros((M, 3))
        np.add.at(g, ei, np.einsum("eab,eb->ea", JiW, r))
        np.add.at(g, ej, np.einsum("eab,eb->ea", JjW, r))
        rows_l, cols_l, data_l = [], [], []
        for a, b, blk in (
            (bi, bi, Hii), (bj, bj, Hjj),
            (bi, bj, Hij), (bj, bi, np.swapaxes(Hij, -1, -2)),
        ):
            ok = (a >= 0) & (b >= 0)
            rr, cc = block_idx(a[ok], b[ok])
            rows_l.append(rr.ravel())
            cols_l.append(cc.ravel())
            data_l.append(blk[ok].ravel())
        H = sp.coo_matrix(
            (np.concatenate(data_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(3 * nf, 3 * nf),
        ).tocsc()
        bvec = g[fidx].ravel()
        # doSPA damping: diagonal ×(1+λ) + jitter (spa2d setupSys)
        Hd = H + sp.diags(H.diagonal() * lam + 1e-12)
        try:
            step = spla.spsolve(Hd, -bvec)
        except Exception:
            step = np.zeros(3 * nf)
        if not np.all(np.isfinite(step)):
            step = np.zeros(3 * nf)
        sq = float(step @ step)
        cand = p.copy()
        cand[fidx] += step.reshape(-1, 3)
        cand[:, 2] = np.arctan2(np.sin(cand[:, 2]), np.cos(cand[:, 2]))
        cn = cost(cand)
        if sq < sq_min_delta:
            break
        if cn < c:
            p, c = cand, cn
            lam *= 0.5
            good += 1
        else:
            lam *= laminc
            laminc *= 2.0
    return p, cost0, c, good


def _lm_loop_program(
    p0, lam0, ei_d, ej_d, means_d, infos_d, mask_d, free_d, schur_part,
    *, M, use_dense, iters, cg_iterations, cg_tolerance, psum_axis=None,
    cg_restarts=1, convergence_delta=1e-16,
):
    """The device-resident doSPA loop body (see PoseGraphSolver.compute).

    With ``psum_axis`` the edge arrays are per-device shards (running
    inside shard_map over a mesh): each device assembles partial normal
    equations / costs from its shard and one psum forms the global system
    — the distributed setupSparseSys (spa2d.cpp:328-413) the reference's
    serial solver never had. Poses and free_mask stay replicated."""

    # transposed (edges-along-lanes) forms: the one-hot maps are O(M·E)
    # memory, so cap where they stay cheap. Works identically under
    # shard_map — each device builds (M, E_shard) maps from its edge
    # shard and the existing psums assemble the partials — keeping mesh
    # and single-device programs numerically in lockstep.
    E_edges = ei_d.shape[0]
    use_T = schur_part is None and M * E_edges <= 64_000_000
    if use_T:
        Gi_T, Gj_T = _onehot_maps(ei_d, ej_d, M, p0.dtype)
        meansT_T = means_d.T
        wE = mask_d.astype(p0.dtype)
        W6_T = jnp.stack(
            [infos_d[:, 0, 0], infos_d[:, 0, 1], infos_d[:, 0, 2],
             infos_d[:, 1, 1], infos_d[:, 1, 2], infos_d[:, 2, 2]]
        ) * wE

    def solve(p, lam):
        if schur_part is not None:
            if p.dtype == jnp.float64:
                # mixed precision: f32 Schur factor + f64 PCG (see
                # mixed_schur_delta).
                # λ is FLOORED at the factor's floor so preconditioner ≡
                # operator: with the true λ → 1e-9 the mismatch
                # concentrates in the softest (global-warp) modes and the
                # capped PCG leaves exactly those unsolved — on the
                # loops-only outdoor graph the LM crawled to cost 7.4 in
                # 113 iterations while the f64 oracle reaches 4.45 in 60.
                # The floor is 1e-5 RELATIVE diagonal damping (diag
                # ×(1+λ)) — negligible bias, exact deltas.
                return mixed_schur_delta(
                    schur_part, p, ei_d, ej_d, means_d, infos_d,
                    mask_d, jnp.maximum(lam, 1e-5), free_d,
                )
            from tpu_slam.solver.schur import schur_delta

            return schur_delta(
                schur_part, p, ei_d, ej_d, means_d, infos_d, mask_d,
                lam, free_d,
            )
        if use_T:
            Hd, Hij, b = normal_equations_T(
                p.T, Gi_T, Gj_T, meansT_T, W6_T
            )
        else:
            Hd, Hij, b = normal_equations(
                p, ei_d, ej_d, means_d, infos_d, mask_d, M
            )
        if use_dense:
            if psum_axis is not None:
                H = jax.lax.psum(
                    assemble_dense(Hd, Hij, ei_d, ej_d), psum_axis
                )
                return finalize_dense_solve(
                    H, jax.lax.psum(b, psum_axis), lam, free_d
                )
            return dense_solve(Hd, Hij, ei_d, ej_d, b, lam, free_d)
        if psum_axis is not None:
            Hd = jax.lax.psum(Hd, psum_axis)
            b = jax.lax.psum(b, psum_axis)
        return cg_solve(
            Hd, Hij, ei_d, ej_d, b, lam, free_d,
            cg_iterations, cg_tolerance, psum_axis,
            restarts=cg_restarts,
        )

    def cost_of(p):
        if use_T:
            c = graph_cost_T(p.T, Gi_T, Gj_T, meansT_T, W6_T)
        else:
            c = graph_cost(p, ei_d, ej_d, means_d, infos_d, mask_d)
        return jax.lax.psum(c, psum_axis) if psum_axis is not None else c

    # sqMinDelta (spa2d.cpp:458) from cfg.convergence_delta. The
    # reference's 1e-16 assumes f64; in f32 ‖δ‖² floors around 1e-9
    # (eps·pose-scale over 3M coords) and the loop would burn its full
    # iteration budget after convergence — so f32 floors the configured
    # threshold at 1e-8 (‖δ‖ ≈ 1e-4 aggregated over ALL nodes, sub-0.1
    # mm); f64 honors it exactly.
    sq_min_delta = _sq_min_delta(convergence_delta, p0.dtype)

    def body(state):
        p, lam, laminc, cost, it, good, _done = state
        delta = solve(p, lam)
        sq = jnp.sum(delta * delta)
        converged = sq < sq_min_delta
        cand = p + delta
        th = jnp.arctan2(jnp.sin(cand[:, 2]), jnp.cos(cand[:, 2]))
        cand = jnp.concatenate([cand[:, :2], th[:, None]], axis=-1)
        new_cost = cost_of(cand)
        accept = (new_cost < cost) & ~converged
        p = jnp.where(accept, cand, p)
        cost = jnp.where(accept, new_cost, cost)
        lam = jnp.where(accept, lam * 0.5, lam * laminc)
        laminc = jnp.where(accept, laminc, laminc * 2.0)
        good = good + accept.astype(jnp.int32)
        return (p, lam, laminc, cost, it + 1, good, converged)

    def cond(state):
        _p, _l, _li, _c, it, _g, done = state
        return (it < iters) & ~done

    cost0 = cost_of(p0)
    state = (
        p0, jnp.asarray(lam0, p0.dtype),
        jnp.asarray(2.0, p0.dtype), cost0,
        jnp.int32(0), jnp.int32(0), jnp.asarray(False),
    )
    p, _, _, cost, _, good, _ = jax.lax.while_loop(cond, body, state)
    return p, cost0, cost, good


class SolveStats(NamedTuple):
    iterations: int
    initial_cost: float
    final_cost: float


_LM_PROGRAM_CACHE: dict = {}
_SCHUR_PART_CACHE: dict = {}
class PoseGraphSolver:
    """Host-facing incremental graph with device-side batched solving.

    Mirrors the ScanSolver ABC: AddNode (spa_solver.cc:24-31), AddConstraint
    (:33-41, information = covariance⁻¹ computed here like the SpaSolver),
    Compute = doSPA(max_iterations) + corrections harvest (:43-91).

    Capacities grow in power-of-two buckets so jitted shapes are reused.
    """

    def __init__(self, cfg: SolverConfig, dtype=jnp.float32,
                 mesh=None, mesh_axis: str = "data"):
        """``mesh``: optional jax.sharding.Mesh — the FULL LM while_loop
        then runs as one shard_map program with constraint edges sharded
        over ``mesh_axis`` and the normal equations / costs assembled by
        psum (graph parallelism, SURVEY §2.5; the distributed analogue of
        setupSparseSys, spa2d.cpp:328-413)."""
        self.cfg = cfg
        self.dtype = dtype
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._poses: list[np.ndarray] = []
        self._edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self._ids: dict[int, int] = {}  # external id → dense index
        # shape key → jitted LM program. MODULE-level (shared by every
        # solver instance): jax's jit cache keys on function identity, so
        # per-instance wrappers would recompile identical programs whenever
        # a fresh solver is built (e.g. the offline mapper rebuilds the
        # graph per round)
        self._lm_cache = _LM_PROGRAM_CACHE

    # --- ScanSolver surface -------------------------------------------------
    def add_node(self, node_id: int, pose) -> None:
        self._ids[node_id] = len(self._poses)
        self._poses.append(np.asarray(pose, np.float64))

    def add_constraint(
        self, id_from: int, id_to: int, mean, covariance=None, information=None
    ) -> None:
        if information is None:
            c = np.asarray(covariance, np.float64)
            try:
                information = np.linalg.inv(c)
            except np.linalg.LinAlgError:
                # degenerate match covariance (collinear response keep-set):
                # the reference dies on its own Inverse assert here
                # (Karto.h:2444-2453); regularize instead (PARITY.md dev. 5)
                information = np.linalg.inv(c + 1e-9 * np.eye(3))
        self._edges.append(
            (
                self._ids[id_from],
                self._ids[id_to],
                np.asarray(mean, np.float64),
                np.asarray(information, np.float64),
            )
        )

    def add_nodes(self, node_ids, poses) -> None:
        """Vectorized add_node for mission-scale graphs."""
        poses = np.asarray(poses, np.float64)
        base = len(self._poses)
        for k, nid in enumerate(node_ids):
            self._ids[nid] = base + k
        self._poses.extend(poses)

    def add_constraints(
        self, ids_from, ids_to, means, covariances=None, informations=None
    ) -> None:
        """Vectorized add_constraint: ONE stacked 3×3 inverse for the whole
        batch — the per-edge Python-loop inverse dominates host graph-build
        time at mission scale (~1.3k edges per offline solve round)."""
        means = np.asarray(means, np.float64)
        if informations is None:
            c = np.asarray(covariances, np.float64)
            try:
                informations = np.linalg.inv(c)
            except np.linalg.LinAlgError:
                # regularize ONLY the degenerate members (same semantics as
                # the scalar path's per-edge fallback)
                informations = np.empty_like(c)
                for k in range(len(c)):
                    try:
                        informations[k] = np.linalg.inv(c[k])
                    except np.linalg.LinAlgError:
                        informations[k] = np.linalg.inv(
                            c[k] + 1e-9 * np.eye(3)
                        )
        else:
            informations = np.asarray(informations, np.float64)
        ids = self._ids
        self._edges.extend(
            (ids[int(a)], ids[int(b)], m, inf)
            for a, b, m, inf in zip(ids_from, ids_to, means, informations)
        )

    def get_poses(self) -> np.ndarray:
        return np.asarray(self._poses)

    def set_node_pose(self, node_id: int, pose) -> None:
        """Overwrite a node's current estimate (karto rewrites scan poses
        between solves, e.g. after a fine loop match)."""
        self._poses[self._ids[node_id]] = np.asarray(pose, np.float64)

    @property
    def num_nodes(self) -> int:
        return len(self._poses)

    @property
    def num_edges(self) -> int:
        return len(self._edges)

    # --- compute ------------------------------------------------------------
    @staticmethod
    def _bucket(n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return b

    def compute(self, max_iterations: int | None = None) -> SolveStats:
        """Run LM; updates stored poses in place (CorrectPoses harvest)."""
        return self.compute_async(max_iterations).harvest()

    def compute_async(
        self, max_iterations: int | None = None
    ) -> "PendingSolve":
        """Dispatch the LM solve without blocking on the result.

        JAX dispatch is asynchronous, so this returns as soon as the device
        program is enqueued; the caller polls ``ready()`` and applies the
        correction with ``harvest()`` — the front-end keeps processing scans
        while the back-end optimizes (pipeline parallelism; the reference's
        CorrectPoses blocks inline, Mapper.cpp:1397-1414)."""
        cfg = self.cfg
        iters = max_iterations or cfg.max_iterations
        M = self._bucket(max(self.num_nodes, 2))
        E = self._bucket(max(self.num_edges, 1))
        if self.mesh is not None:
            D = self.mesh.shape[self.mesh_axis]
            while E % D:  # edge shards must tile the mesh axis
                E *= 2
        use_dense = self.num_nodes <= cfg.use_dense_below

        poses = np.zeros((M, 3))
        poses[: self.num_nodes] = np.asarray(self._poses)

        ei = np.zeros(E, np.int32)
        ej = np.zeros(E, np.int32)
        means = np.zeros((E, 3))
        infos = np.zeros((E, 3, 3))
        mask = np.zeros(E, bool)
        for k, (i, j, m, w) in enumerate(self._edges):
            ei[k], ej[k], means[k], infos[k], mask[k] = i, j, m, w, True
        free = np.zeros(M, bool)
        free[1 : self.num_nodes] = True  # node 0 gauge-fixed (nFixed=1)

        # exact f64 fallback (cfg.f64_schur_above): large mission graphs
        # (multi-stride skip/anchor edges, no band) are exactly the ones
        # where f32 CG is algorithmically inadequate (chain condition
        # ~1e6: 1.19 m ATE against the 0.651 m f64 oracle on the 6k
        # outdoor graph).
        if (self.mesh is None and self.dtype == jnp.float32
                and cfg.f64_schur_above > 0
                and self.num_nodes >= cfg.f64_schur_above):
            if cfg.host_direct_fallback:
                # see _host_direct_lm: these irregular ill-conditioned
                # graphs need an f64 factorization, which the host's
                # sparse direct solve gives exactly
                p64, c0, c, good = _host_direct_lm(
                    poses, ei[mask], ej[mask], means[mask], infos[mask],
                    mask[mask], free, iters, cfg.initial_lambda,
                    _sq_min_delta(cfg.convergence_delta, jnp.float64),
                )
                return PendingSolve(
                    self,
                    (p64, np.float64(c0), np.float64(c), np.int32(good)),
                    self.num_nodes,
                )
            return self._compute_f64_schur(
                iters, poses, ei, ej, means, infos, mask, free, M, E
            )

        jd = functools.partial(jnp.asarray, dtype=self.dtype)
        poses_d = jd(poses)
        ei_d, ej_d = jnp.asarray(ei), jnp.asarray(ej)
        means_d, infos_d = jd(means), jd(infos)
        mask_d = jnp.asarray(mask)
        free_d = jnp.asarray(free)

        schur_part = None
        if (self.mesh is None and cfg.use_schur
                and self.num_nodes > 2 * cfg.schur_submaps
                # below use_dense_below the dense path wins and the
                # per-compute host partitioning isn't worth it
                and self.num_nodes >= cfg.use_dense_below):
            from tpu_slam.solver.schur import (
                bucket_partition, build_partition,
            )

            # host-side partition of the current graph (data-dependent);
            # the device LM loop below consumes its fixed-shape index maps.
            # Widths are bucketed so the compiled program is reused as the
            # mission grows (a fresh shape = a fresh compile per loop
            # closure otherwise). The partition itself is cached by graph
            # content: the offline pipeline rebuilds an identical graph
            # every solve round, and the numpy partitioning can cost more
            # than the device solve it prepares.
            schur_part = self._schur_partition(ei, ej, mask, M)

        # The entire doSPA LM loop (spa2d.cpp:455-607) runs as ONE device
        # program: a host round trip per iteration would cost more than the
        # iteration's device work. λ accept/reject and the ‖δ‖² stop are
        # lax control flow; the iteration cap is static. Compiled programs are cached by
        # (bucketed) shape so the growing SLAM graph reuses executables —
        # graph content (edges, partition index maps) flows in as arguments.
        key = (
            M, E, use_dense, iters,
            cfg.cg_iterations, cfg.cg_tolerance, cfg.cg_restarts,
            cfg.convergence_delta, self.dtype,
            None if self.mesh is None else (self.mesh, self.mesh_axis),
            None if schur_part is None else tuple(
                a.shape for a in jax.tree_util.tree_leaves(schur_part)
            ),
        )
        if key not in self._lm_cache:
            if self.mesh is not None:
                from jax.sharding import PartitionSpec as P

                ax = self.mesh_axis
                body = functools.partial(
                    _lm_loop_program, M=M, use_dense=use_dense,
                    iters=iters, cg_iterations=cfg.cg_iterations,
                    cg_tolerance=cfg.cg_tolerance, psum_axis=ax,
                    cg_restarts=cfg.cg_restarts, schur_part=None,
                    convergence_delta=cfg.convergence_delta,
                )
                self._lm_cache[key] = jax.jit(
                    jax.shard_map(
                        body,
                        mesh=self.mesh,
                        in_specs=(P(), P(), P(ax), P(ax), P(ax), P(ax),
                                  P(ax), P()),
                        out_specs=(P(), P(), P(), P()),
                    )
                )
            else:
                self._lm_cache[key] = jax.jit(
                    functools.partial(
                        _lm_loop_program, M=M, use_dense=use_dense,
                        iters=iters, cg_iterations=cfg.cg_iterations,
                        cg_tolerance=cfg.cg_tolerance,
                        cg_restarts=cfg.cg_restarts,
                        convergence_delta=cfg.convergence_delta,
                    )
                )
        if self.mesh is not None:
            if jax.process_count() > 1:
                # multi-host mesh: host-local numpy can't be auto-sharded
                # onto non-addressable devices; build global arrays from
                # per-process shards (every process holds identical data)
                from jax.sharding import NamedSharding, PartitionSpec as P

                def mk(x, spec):
                    x = np.asarray(x)
                    return jax.make_array_from_callback(
                        x.shape, NamedSharding(self.mesh, spec),
                        lambda idx: x[idx],
                    )

                ax = P(self.mesh_axis)
                poses_d = mk(poses.astype(self.dtype), P())
                ei_d, ej_d = mk(ei, ax), mk(ej, ax)
                means_d = mk(means.astype(self.dtype), ax)
                infos_d = mk(infos.astype(self.dtype), ax)
                mask_d = mk(mask, ax)
                free_d = mk(free, P())
            arrays = self._lm_cache[key](
                poses_d, jnp.asarray(cfg.initial_lambda, self.dtype),
                ei_d, ej_d, means_d, infos_d, mask_d, free_d,
            )
        else:
            arrays = self._lm_cache[key](
                poses_d, jnp.asarray(cfg.initial_lambda, self.dtype),
                ei_d, ej_d, means_d, infos_d, mask_d, free_d, schur_part,
            )
        return PendingSolve(self, arrays, self.num_nodes)

    def _schur_partition(self, ei, ej, mask, M):
        """Cached host-side Schur partition of the current graph
        (data-dependent; the device LM loop consumes its fixed-shape
        index maps — see the notes at the f32 call site).

        The f64 path never factors in f64 — it reuses the f32 factor as a
        PCG preconditioner (mixed_schur_delta)."""
        import hashlib

        from tpu_slam.solver.schur import bucket_partition, build_partition

        cfg = self.cfg
        hk = hashlib.blake2b(digest_size=16)  # content digest — a
        # built-in hash() collision would silently reuse a WRONG
        # partition and corrupt the Schur solve
        hk.update(ei.tobytes())
        hk.update(ej.tobytes())
        hk.update(mask.tobytes())
        pkey = (M, cfg.schur_submaps, hk.digest())
        schur_part = _SCHUR_PART_CACHE.get(pkey)
        if schur_part is None:
            schur_part = bucket_partition(
                build_partition(ei, ej, mask, M, cfg.schur_submaps)
            )
            if len(_SCHUR_PART_CACHE) > 64:
                _SCHUR_PART_CACHE.clear()
            _SCHUR_PART_CACHE[pkey] = schur_part
        return schur_part

    def _compute_f64_schur(
        self, iters, poses, ei, ej, means, infos, mask, free, M, E
    ) -> "PendingSolve":
        """Exact large-graph fallback: the full LM while_loop with the
        direct Schur-complement step (solver/schur.py), run in float64.

        Everything — array upload, (re)trace and dispatch — happens under
        jax.enable_x64: jax caches compiled programs per config state, so
        a call outside the scope would silently retrace at f32."""
        import contextlib

        cfg = self.cfg
        schur_part = self._schur_partition(ei, ej, mask, M)

        key = (
            "f64schur", M, E, iters, cfg.convergence_delta,
            tuple(a.shape for a in jax.tree_util.tree_leaves(schur_part)),
        )
        with contextlib.ExitStack() as stack:
            stack.enter_context(jax.enable_x64(True))
            if key not in self._lm_cache:
                self._lm_cache[key] = jax.jit(
                    functools.partial(
                        _lm_loop_program, M=M, use_dense=False,
                        iters=iters, cg_iterations=cfg.cg_iterations,
                        cg_tolerance=cfg.cg_tolerance, cg_restarts=1,
                        convergence_delta=cfg.convergence_delta,
                    )
                )
            jd = functools.partial(jnp.asarray, dtype=jnp.float64)
            arrays = self._lm_cache[key](
                jd(poses), jnp.asarray(cfg.initial_lambda, jnp.float64),
                jnp.asarray(ei), jnp.asarray(ej), jd(means), jd(infos),
                jnp.asarray(mask), jnp.asarray(free), schur_part,
            )
        return PendingSolve(self, arrays, self.num_nodes)

    def clear(self) -> None:
        """ScanSolver::Clear — drop graph (karto re-adds after loop)."""
        self._poses.clear()
        self._edges.clear()
        self._ids.clear()


class PendingSolve:
    """Handle to an in-flight LM solve (device arrays not yet fetched)."""

    def __init__(self, solver: PoseGraphSolver, arrays, n_nodes: int):
        self._solver = solver
        self._arrays = arrays
        self.n_nodes = n_nodes  # snapshot size: nodes included in the solve
        self._stats: SolveStats | None = None

    def ready(self) -> bool:
        """True once the device result can be harvested without blocking."""
        if self._stats is not None:
            return True
        is_ready = getattr(self._arrays[0], "is_ready", None)
        return bool(is_ready()) if callable(is_ready) else True

    def harvest(self) -> SolveStats:
        """Fetch the result (blocking if needed) and write the corrected
        poses of the snapshot's nodes back into the solver."""
        if self._stats is not None:
            return self._stats
        poses_d, cost0_d, cost_d, good_d = self._arrays

        def fetch(a):
            # multi-host replicated outputs aren't fully addressable; every
            # process reads its own (complete, replicated) shard
            if getattr(a, "is_fully_addressable", True):
                return np.array(a, np.float64)
            return np.array(a.addressable_shards[0].data, np.float64)

        s = self._solver
        # np.array (copy): asarray can return a read-only zero-copy view
        # of the device buffer when dtypes already match (x64 path)
        out = fetch(poses_d)
        out[0] = s._poses[0]  # fixed node untouched
        for k in range(self.n_nodes):
            s._poses[k] = out[k]
        self._stats = SolveStats(
            int(fetch(good_d)), float(fetch(cost0_d)), float(fetch(cost_d))
        )
        return self._stats
