"""Point-to-point ICP.

Replacement for `pcl::IterativeClosestPoint` as used by
`lesson2/src/scan_match_icp.cc:135-164` (frame-to-frame matching of
consecutive scans). The reference needs ~0.12 s/frame through PCL's KD-tree;
here each iteration is one batched nearest-neighbor matmul + a closed-form
2D Procrustes update, unrolled under `lax.scan` (fixed iteration count,
static shapes), and the whole matcher vmaps over scan-pair batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_slam import geometry as geo
from tpu_slam.config import ICPConfig
from tpu_slam.ops.matching import nearest_neighbor


def procrustes_step(
    src_w: jax.Array,
    tgt_q: jax.Array,
    w: jax.Array,
) -> jax.Array:
    """Closed-form weighted 2D rigid alignment src→tgt.

    θ* = atan2(Σw (p×q), Σw (p·q)) on centered points; the 2D specialization
    of the SVD solve inside PCL's transform estimation.
    Returns a pose (3,) (or batch) to left-compose onto the current estimate.
    """
    wsum = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    mu_p = jnp.sum(src_w * w[..., None], axis=-2) / wsum
    mu_q = jnp.sum(tgt_q * w[..., None], axis=-2) / wsum
    p = src_w - mu_p[..., None, :]
    q = tgt_q - mu_q[..., None, :]
    dot = jnp.sum(w * (p * q).sum(-1), axis=-1)
    crs = jnp.sum(w * (p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]), axis=-1)
    th = jnp.arctan2(crs, dot)
    c, s = jnp.cos(th), jnp.sin(th)
    tx = mu_q[..., 0] - (c * mu_p[..., 0] - s * mu_p[..., 1])
    ty = mu_q[..., 1] - (s * mu_p[..., 0] + c * mu_p[..., 1])
    return jnp.stack([tx, ty, th], axis=-1)


def icp_match(
    src_pts: jax.Array,
    src_valid: jax.Array,
    tgt_pts: jax.Array,
    tgt_valid: jax.Array,
    cfg: ICPConfig,
    init_pose: jax.Array | None = None,
):
    """Estimate pose T with T∘src ≈ tgt (src expressed in tgt's frame).

    Matches the semantics of `icp_.align(...)` + `getFinalTransformation`
    (scan_match_icp.cc:138-158). Returns (pose (..., 3), mean_sq_err, n_corr).
    Fully batched over leading axes.
    """
    if init_pose is None:
        init_pose = jnp.zeros(src_pts.shape[:-2] + (3,), src_pts.dtype)

    # zero invalid/non-finite beams so masked reductions stay finite
    src_pts = jnp.where(
        src_valid[..., None] & jnp.isfinite(src_pts), src_pts, 0.0
    )
    tgt_pts = jnp.where(
        tgt_valid[..., None] & jnp.isfinite(tgt_pts), tgt_pts, 0.0
    )
    tgt_valid = tgt_valid & jnp.all(jnp.isfinite(tgt_pts), axis=-1)

    max_d2 = cfg.max_correspondence_dist**2

    def body(pose, _):
        src_w = geo.apply(pose, src_pts)
        idx, d2 = nearest_neighbor(src_w, tgt_pts, tgt_valid)
        w = (src_valid & (d2 < max_d2)).astype(src_pts.dtype)
        q = jnp.take_along_axis(tgt_pts, idx[..., None], axis=-2)
        delta = procrustes_step(src_w, q, w)
        new_pose = geo.compose(delta, pose)
        err = jnp.sum(w * d2, axis=-1) / jnp.maximum(jnp.sum(w, axis=-1), 1.0)
        return new_pose, (err, jnp.sum(w, axis=-1))

    pose, (errs, ns) = jax.lax.scan(
        body, init_pose, None, length=cfg.max_iterations
    )
    return pose, errs[-1], ns[-1]
