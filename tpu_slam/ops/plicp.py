"""PL-ICP: point-to-line ICP with CSM-style outlier trimming.

Re-design of CSM's `sm_icp` (Censi's PL-ICP) as driven by
`lesson3/src/scan_match_plicp.cc:38-300` and `lesson3/src/plicp_odometry.cc:
327-436`. The reference's per-point correspondence "tricks", adjacent-beam
second point, percentile/adaptive outlier trimming, and point-to-line
minimization (CSM params documented at plicp_odometry.cc:69-186) are
reproduced as fixed-shape batched tensor ops:

  * correspondences: exhaustive masked nearest-neighbor (exact differences)
  * j2 = better of j1±1 (csm icp_corr semantics) → line (q1, q2), normal n
  * trimming: outliers_maxPerc percentile gate + adaptive-order quantile gate
    (plicp_odometry.cc:139-156) via masked sort quantiles
  * minimization: Gauss-Newton on r_i = nᵀ(R(θ)p_i + t − q1_i); the 3×3
    normal-equation solve replaces CSM's exact gpc polynomial solver —
    identical fixed point, and the linearized step vmaps/batches cleanly.

The whole matcher is a `lax.scan` over a fixed round count: one compiled
program, batchable over B scan pairs for data-parallel throughput
(SURVEY §2.5 "data parallelism over scans").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tpu_slam import geometry as geo
from tpu_slam.config import PLICPConfig
from tpu_slam.ops.matching import (
    BIG,
    masked_quantiles,
    nearest_neighbor,
    second_point_on_segment,
)

_HI = jax.lax.Precision.HIGHEST


class PLICPResult(NamedTuple):
    pose: jax.Array  # (..., 3) transform: tgt_frame ← src_frame
    error: jax.Array  # (...,) mean |point-to-line| residual of inliers
    num_inliers: jax.Array  # (...,)
    covariance: jax.Array  # (..., 3, 3) GN covariance  σ²·H⁻¹
    converged: jax.Array  # (...,) bool — last step below epsilon


def _correspondences(pose, src_pts, src_valid, tgt_pts, tgt_valid, cfg,
                     point_to_line: bool):
    """One correspondence round → (q1, n, residual, gate)."""
    src_w = geo.apply(pose, src_pts)
    j1, d2 = nearest_neighbor(src_w, tgt_pts, tgt_valid)
    q1 = jnp.take_along_axis(tgt_pts, j1[..., None], axis=-2)
    gate = src_valid & (d2 < cfg.max_correspondence_dist**2)
    gate &= jnp.take_along_axis(tgt_valid, j1, axis=-1)

    if point_to_line:
        j2 = second_point_on_segment(j1, src_w, tgt_pts, tgt_valid)
        q2 = jnp.take_along_axis(tgt_pts, j2[..., None], axis=-2)
        tang = q2 - q1
        tlen = jnp.linalg.norm(tang, axis=-1)
        ok = tlen > 1e-9
        tang = tang / jnp.maximum(tlen, 1e-9)[..., None]
        n = jnp.stack([-tang[..., 1], tang[..., 0]], axis=-1)
        gate &= ok & jnp.take_along_axis(tgt_valid, j2, axis=-1)
        resid = jnp.sum(n * (src_w - q1), axis=-1)
    else:
        # vanilla ICP config (use_point_to_line_distance=0): 2D residual kept
        # as two scalar rows handled by the caller; here reduce to the
        # distance direction (unit vector towards q1)
        diff = src_w - q1
        dist = jnp.linalg.norm(diff, axis=-1)
        n = diff / jnp.maximum(dist, 1e-9)[..., None]
        resid = dist
    return src_w, q1, n, resid, gate


def _trim(resid, gate, cfg):
    """CSM outlier rejection: keep |err| ≤ maxPerc percentile AND
    |err| ≤ adaptive_mult × (adaptive_order percentile)."""
    err = jnp.abs(resid)
    q_perc, q_adap = masked_quantiles(
        err, gate, (cfg.outliers_maxPerc, cfg.outliers_adaptive_order)
    )
    thr_perc = q_perc
    thr_adap = cfg.outliers_adaptive_mult * q_adap
    thr = jnp.minimum(thr_perc, jnp.maximum(thr_adap, 1e-6))
    return gate & (err <= thr[..., None] + 1e-12)


def _gn_step(pose, src_pts, src_w, q1, n, w, damping=1e-9):
    """One Gauss-Newton step on Σ w (nᵀ(R p + t − q1))²."""
    # d(R p)/dθ = perp(R(θ) p) (rotation of the already-rotated point about
    # the origin, translation excluded)
    rp = src_w - pose[..., None, :2]
    drot = jnp.stack([-rp[..., 1], rp[..., 0]], axis=-1)
    j_th = jnp.sum(n * drot, axis=-1)
    J = jnp.concatenate([n, j_th[..., None]], axis=-1)  # (..., N, 3)
    r = jnp.sum(n * (src_w - q1), axis=-1)  # (..., N)
    Jw = J * w[..., None]
    # HIGHEST: a float32 contraction over the beams may otherwise run in
    # TF32 (about 10 mantissa bits) on a GPU, which moves the GN step
    H = jnp.einsum("...ni,...nj->...ij", Jw, J,
                   preferred_element_type=src_pts.dtype, precision=_HI)
    H = H + damping * jnp.eye(3, dtype=H.dtype)
    b = -jnp.einsum("...ni,...n->...i", Jw, r,
                    preferred_element_type=src_pts.dtype, precision=_HI)
    delta = jnp.linalg.solve(H, b[..., None])[..., 0]
    # degenerate-solve guard (CSM "not converged" analogue,
    # plicp_odometry.cc:416): too few inliers or non-finite step → no update
    ok = (jnp.sum(w, axis=-1) >= 3) & jnp.all(
        jnp.isfinite(delta), axis=-1
    )
    delta = jnp.where(ok[..., None], delta, 0.0)
    new_pose = jnp.stack(
        [
            pose[..., 0] + delta[..., 0],
            pose[..., 1] + delta[..., 1],
            geo.normalize_angle(pose[..., 2] + delta[..., 2]),
        ],
        axis=-1,
    )
    return new_pose, delta, H


def plicp_match(
    src_pts: jax.Array,
    src_valid: jax.Array,
    tgt_pts: jax.Array,
    tgt_valid: jax.Array,
    cfg: PLICPConfig,
    init_pose: jax.Array | None = None,
) -> PLICPResult:
    """Estimate T with T∘src ≈ tgt — CSM `sm_icp(&input_,&output_)` semantics
    (plicp_odometry.cc:391): src = laser_sens, tgt = laser_ref (keyframe),
    init_pose = first_guess, returned pose = output_.x.

    Batched over leading axes; jit/vmap-safe (fixed max_iterations rounds,
    convergence reported, not branched on).
    """
    if init_pose is None:
        init_pose = jnp.zeros(src_pts.shape[:-2] + (3,), src_pts.dtype)
    p2l = cfg.use_point_to_line_distance
    # sanitize: invalid beams may carry inf/NaN coordinates; zero them so the
    # masked reductions stay finite (0-weight × inf would still poison sums)
    src_pts = jnp.where(
        src_valid[..., None] & jnp.isfinite(src_pts), src_pts, 0.0
    )
    tgt_pts = jnp.where(
        tgt_valid[..., None] & jnp.isfinite(tgt_pts), tgt_pts, 0.0
    )
    tgt_valid = tgt_valid & jnp.all(jnp.isfinite(tgt_pts), axis=-1)

    def round_fn(carry, _):
        pose, conv, pe, pni, pH = carry
        src_w, q1, n, resid, gate = _correspondences(
            pose, src_pts, src_valid, tgt_pts, tgt_valid, cfg, p2l
        )
        w = _trim(resid, gate, cfg).astype(src_pts.dtype)
        # two inner GN steps with frozen correspondences (cheap, improves the
        # per-round fixed point towards CSM's exact per-round solve)
        pose1, delta, H = _gn_step(pose, src_pts, src_w, q1, n, w)
        src_w1 = geo.apply(pose1, src_pts)
        pose2, delta2, H = _gn_step(pose1, src_pts, src_w1, q1, n, w)
        err = jnp.sum(w * jnp.abs(resid), axis=-1) / jnp.maximum(
            jnp.sum(w, axis=-1), 1.0
        )
        step = delta + delta2
        # per-pair termination (CSM sm_icp: each call stops at its own
        # epsilons): converged pairs freeze pose and stats
        pose2 = jnp.where(conv[..., None], pose, pose2)
        err = jnp.where(conv, pe, err)
        ninl = jnp.where(conv, pni, jnp.sum(w > 0, axis=-1))
        H = jnp.where(conv[..., None, None], pH, H)
        conv = conv | (
            (jnp.abs(step[..., 0]) < cfg.epsilon_xy)
            & (jnp.abs(step[..., 1]) < cfg.epsilon_xy)
            & (jnp.abs(step[..., 2]) < cfg.epsilon_theta)
        )
        return (pose2, conv, err, ninl, H), None

    b = init_pose.shape[:-1]
    carry0 = (
        init_pose,
        jnp.zeros(b, bool),
        jnp.zeros(b, init_pose.dtype),
        jnp.zeros(b, jnp.int32),
        jnp.zeros(b + (3, 3), init_pose.dtype),
    )
    (pose, convs, errs, ns, H_last), _ = jax.lax.scan(
        round_fn, carry0, None, length=cfg.max_iterations
    )
    # Censi-style covariance stand-in: σ² H⁻¹ (do_compute_covariance analogue)
    cov = cfg.sigma**2 * jnp.linalg.inv(
        H_last + 1e-6 * jnp.eye(3, dtype=pose.dtype)
    )
    return PLICPResult(
        pose=pose,
        error=errs,
        num_inliers=ns,
        covariance=cov,
        converged=convs,
    )
