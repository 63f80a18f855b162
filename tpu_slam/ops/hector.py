"""Hector scan-to-map Gauss-Newton matcher.

Re-design of the hector_slam matcher stack
(`lesson4/include/lesson4/hector_mapping/`):

  * bilinear map value + gradient at each beam endpoint
    (`map/OccGridMapUtil.h:139-228` interpMapValueWithDerivatives)
  * per-beam H (3×3) / dTr accumulation
    (`map/OccGridMapUtil.h:77-132` getCompleteHessianDerivs)
  * GN iterations with the ±0.2 rad rotation clamp
    (`matcher/ScanMatcher.h:60-139` matchData/estimateTransformationLogLh)
  * coarse-to-fine over the multi-resolution pyramid
    (`slam_main/MapRepMultiMap.h:144-167` matchData)

The per-beam loop + per-scan cell cache of the reference becomes one fused
batched gather/arithmetic program per GN step; the whole multi-level match is
a single jittable function (fixed level count and iteration counts).

Like the reference, matching runs in *map coords*: poses and points are
scaled by 1/resolution so the GN state is in cells; gradients are per-cell.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_slam import geometry as geo
from tpu_slam.config import GridConfig, HectorConfig


def interp_map_with_derivs(
    prob_flat: jax.Array, size_x: int, size_y: int, coords: jax.Array
):
    """Bilinear occupancy probability + (d/dx, d/dy) at fractional cell
    coords (..., 2). Out-of-bounds → (0, 0, 0), exactly the
    pointOutOfMapBounds early-out (OccGridMapUtil.h:146-150)."""
    x, y = coords[..., 0], coords[..., 1]
    # reference bounds check uses the float coords against [0, size-1)
    inb = (x >= 0.0) & (y >= 0.0) & (x < size_x - 1) & (y < size_y - 1)
    x0 = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, size_x - 2)
    y0 = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, size_y - 2)
    fx = x - x0.astype(coords.dtype)
    fy = y - y0.astype(coords.dtype)

    base = y0 * size_x + x0
    p00 = prob_flat[base]
    p10 = prob_flat[base + 1]
    p01 = prob_flat[base + size_x]
    p11 = prob_flat[base + size_x + 1]

    xi, yi = 1.0 - fx, 1.0 - fy
    val = (p00 * xi + p10 * fx) * yi + (p01 * xi + p11 * fx) * fy
    # d/dx = -((p00-p10)(1-fy) + (p01-p11) fy); d/dy analogous
    # (OccGridMapUtil.h:205-222, with the repo's corrected factors)
    dx = -((p00 - p10) * yi + (p01 - p11) * fy)
    dy = -((p00 - p01) * xi + (p10 - p11) * fx)
    zero = jnp.zeros_like(val)
    return (
        jnp.where(inb, val, zero),
        jnp.where(inb, dx, zero),
        jnp.where(inb, dy, zero),
    )


def hessian_derivs(
    prob_flat: jax.Array,
    size_x: int,
    size_y: int,
    pose_map: jax.Array,
    pts_map: jax.Array,
    valid: jax.Array,
):
    """H (3,3) and dTr (3,) for the pose in map coords
    (getCompleteHessianDerivs, OccGridMapUtil.h:77-132)."""
    pw = geo.apply(pose_map, pts_map)
    # Query at cell CENTERS: the rasterizer stores cell [i,i+1) values; the
    # reference interpolates them as if they were node samples at i, which
    # introduces a systematic half-cell bias (OccGridMapUtil.h:152 indMin =
    # floor(coords) with no center offset). Subtracting 0.5 removes the bias
    # while keeping the reference's raster layout.
    val, dx, dy = interp_map_with_derivs(prob_flat, size_x, size_y, pw - 0.5)
    w = valid.astype(pts_map.dtype)
    c = jnp.cos(pose_map[..., 2])[..., None]
    s = jnp.sin(pose_map[..., 2])[..., None]
    rot = (
        (-s * pts_map[..., 0] - c * pts_map[..., 1]) * dx
        + (c * pts_map[..., 0] - s * pts_map[..., 1]) * dy
    )
    J = jnp.stack([dx * w, dy * w, rot * w], axis=-1)  # (..., N, 3)
    # HIGHEST: a float32 contraction over the beams may otherwise run in
    # TF32 on a GPU, and the GN step would lose its low bits
    dTr = jnp.einsum("...ni,...n->...i", J, (1.0 - val),
                     preferred_element_type=pts_map.dtype,
                     precision=jax.lax.Precision.HIGHEST)
    H = jnp.einsum("...ni,...nj->...ij", J, J,
                   preferred_element_type=pts_map.dtype,
                   precision=jax.lax.Precision.HIGHEST)
    return H, dTr


def gn_step(
    prob_flat, size_x, size_y, pose_map, pts_map, valid, max_rot_step: float
):
    """One estimateTransformationLogLh step (ScanMatcher.h:107-139)."""
    H, dTr = hessian_derivs(prob_flat, size_x, size_y, pose_map, pts_map, valid)
    ok = (H[..., 0, 0] != 0.0) & (H[..., 1, 1] != 0.0)
    Hs = H + 1e-9 * jnp.eye(3, dtype=H.dtype)
    delta = jnp.linalg.solve(Hs, dTr[..., None])[..., 0]
    delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
    # ±max_rot_step clamp on the angle increment (ScanMatcher.h:120-135)
    dth = jnp.clip(delta[..., 2], -max_rot_step, max_rot_step)
    delta = jnp.concatenate([delta[..., :2], dth[..., None]], axis=-1)
    delta = jnp.where(ok[..., None], delta, 0.0)
    return pose_map + delta, H


def match_level(
    prob_flat,
    size_x: int,
    size_y: int,
    pose_map: jax.Array,
    pts_map: jax.Array,
    valid: jax.Array,
    iterations: int,
    max_rot_step: float = 0.2,
):
    """ScanMatcher::matchData at one pyramid level: 1 + iterations GN steps
    (the reference runs estimateTransformationLogLh once, then numIter more,
    ScanMatcher.h:73-86). Returns (pose_map, H of last step)."""

    def body(carry, _):
        pose, _ = carry
        pose, H = gn_step(
            prob_flat, size_x, size_y, pose, pts_map, valid, max_rot_step
        )
        return (pose, H), None

    H0 = jnp.zeros(pose_map.shape[:-1] + (3, 3), pose_map.dtype)
    (pose, H), _ = jax.lax.scan(
        body, (pose_map, H0), None, length=iterations + 1
    )
    pose = jnp.concatenate(
        [pose[..., :2], geo.normalize_angle(pose[..., 2])[..., None]], axis=-1
    )
    return pose, H


def likelihood_for_state(
    prob_flat, size_x: int, size_y: int, pose_map, pts_map, valid
):
    """Scan likelihood of a map-coords pose: 1 − residual/N with residual =
    Σ (1 − M(T(state)·p)) over beams (getLikelihoodForState /
    getResidualForState / getLikelihoodForResidual,
    OccGridMapUtil.h:342-373). The reference's DataContainer holds only
    valid beams; here invalid beams are masked out of both the residual and
    the count. Broadcasts over leading pose axes."""
    pw = geo.apply(pose_map, pts_map)
    val, _, _ = interp_map_with_derivs(prob_flat, size_x, size_y, pw - 0.5)
    w = valid.astype(pts_map.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    resid = jnp.sum(w * (1.0 - val), axis=-1)
    return 1.0 - resid / n


def sampling_covariance(
    prob_flat,
    size_x: int,
    size_y: int,
    pose_map: jax.Array,
    pts_map: jax.Array,
    valid: jax.Array,
    delta_trans: float = 1.5,
    delta_ang: float = 0.05,
):
    """Sampling-based pose covariance (getCovarianceForPose,
    OccGridMapUtil.h:249-306): likelihood-weighted mean/second-moment of 7
    sigma poses (±Δxy in map cells, ±Δθ, center) around the matched pose.
    The reference evaluates the 7 likelihoods in a sequential loop; here
    they are ONE batched map query. Returns the 3×3 covariance in map
    coordinates (cells², cell·rad, rad²), like the reference."""
    x, y, a = pose_map[..., 0], pose_map[..., 1], pose_map[..., 2]
    dt = jnp.asarray(delta_trans, pose_map.dtype)
    da = jnp.asarray(delta_ang, pose_map.dtype)
    sig = jnp.stack(
        [
            jnp.stack([x + dt, y, a], axis=-1),
            jnp.stack([x - dt, y, a], axis=-1),
            jnp.stack([x, y + dt, a], axis=-1),
            jnp.stack([x, y - dt, a], axis=-1),
            jnp.stack([x, y, a + da], axis=-1),
            jnp.stack([x, y, a - da], axis=-1),
            pose_map,
        ],
        axis=-2,
    )  # (..., 7, 3)
    lh = likelihood_for_state(
        prob_flat, size_x, size_y, sig,
        jnp.broadcast_to(pts_map, sig.shape[:-1] + pts_map.shape[-2:]),
        jnp.broadcast_to(valid, sig.shape[:-1] + valid.shape[-1:]),
    )  # (..., 7)
    # all-zero likelihoods (pose entirely off-map / unseen cells) → uniform
    # weights instead of the reference's 1/0 (a finite, large covariance
    # beats silently propagating NaN)
    tot = jnp.sum(lh, axis=-1, keepdims=True)
    wn = jnp.where(tot > 0.0, lh / jnp.where(tot > 0.0, tot, 1.0), 1.0 / 7.0)
    mean = jnp.sum(wn[..., None] * sig, axis=-2)
    d = sig - mean[..., None, :]
    return jnp.einsum(
        "...k,...ki,...kj->...ij", wn, d, d,
        preferred_element_type=pose_map.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )


def world_pose_to_map(cfg: GridConfig, pose: jax.Array) -> jax.Array:
    """World pose → map-coords pose (getMapCoordsPose: xy scaled/offset,
    θ unchanged — GridMapBase.h:270-286)."""
    xy = (pose[..., :2] - jnp.asarray(
        [cfg.origin_x, cfg.origin_y], pose.dtype
    )) / cfg.resolution
    return jnp.concatenate([xy, pose[..., 2:3]], axis=-1)


def map_pose_to_world(cfg: GridConfig, pose: jax.Array) -> jax.Array:
    xy = pose[..., :2] * cfg.resolution + jnp.asarray(
        [cfg.origin_x, cfg.origin_y], pose.dtype
    )
    return jnp.concatenate([xy, pose[..., 2:3]], axis=-1)


def match_multires(
    prob_flats: list,
    grid_cfgs: list,
    pose_world: jax.Array,
    pts_laser: jax.Array,
    valid: jax.Array,
    hcfg: HectorConfig,
):
    """Coarse-to-fine match over the pyramid (MapRepMultiMap.h:144-167):
    level L-1 (coarsest) → 0, using each level's solution as the next init.
    3 GN iters per coarse level, ``iterations_fine`` at level 0.

    prob_flats[i]: occupancy-prob grid of level i (flat); grid_cfgs[i] its
    geometry (resolution × 2^i). pts_laser: beam endpoints in the laser
    frame (meters). Returns (pose_world, H_finest)."""
    pose = pose_world
    H = None
    for lvl in range(len(prob_flats) - 1, -1, -1):
        cfg = grid_cfgs[lvl]
        iters = hcfg.iterations_fine if lvl == 0 else hcfg.iterations_coarse
        pose_map = world_pose_to_map(cfg, pose)
        pts_map = pts_laser / cfg.resolution  # DataContainer setFrom scaling
        pose_map, H = match_level(
            prob_flats[lvl],
            cfg.size_x,
            cfg.size_y,
            pose_map,
            pts_map,
            valid,
            iters,
            hcfg.max_rot_step,
        )
        pose = map_pose_to_world(cfg, pose_map)
    return pose, H
