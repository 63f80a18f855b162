"""LIO-SAM-style corner feature extraction.

Re-design of `lesson1/src/feature_detection.cc:77-179`:
  * drop inf/NaN points          → stable masked reorder (static shape)
  * curvature = (Σ±5 neighbors − 10·r)²   (:112-124) → 1D convolution
  * 6 sectors, sort by curvature, keep ≤20 above threshold 1.0 per sector
    (:139-171)                   → per-sector masked top-k

The reference's compaction changes neighbor relations (curvature is computed
over the *valid-only* sequence); we reproduce that exactly by computing the
convolution on the compacted ordering, then scattering selections back to
original beam indices. Fully batched: works on (B, N) range batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_slam.config import FeatureConfig
from tpu_slam.data.scan import Scan
from tpu_slam.ops.preprocess import compact_order


def curvature_compacted(
    ranges: jax.Array, valid: jax.Array, half_window: int = 5
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Curvature over the valid-compacted beam sequence.

    Returns (curvature (..., N) in compacted order, order (..., N), count).
    Border elements (first/last ``half_window`` valid beams) get curvature 0,
    matching the reference loop bounds ``i in [5, count-5)`` (:112).
    """
    n = ranges.shape[-1]
    order, count = compact_order(valid)
    r = jnp.take_along_axis(ranges, order, axis=-1)
    r = jnp.where(jnp.arange(n) < count[..., None], r, 0.0)

    # kernel [1]*hw + [-2*hw] + [1]*hw as a same-padded correlation
    k = jnp.ones((2 * half_window + 1,), dtype=ranges.dtype)
    k = k.at[half_window].set(-2.0 * half_window)
    flat = r.reshape((-1, 1, n))
    diff = jax.lax.conv_general_dilated(
        flat,
        k.reshape((1, 1, -1)),
        window_strides=(1,),
        padding=((half_window, half_window),),
        dimension_numbers=("NCH", "OIH", "NCH"),
    ).reshape(r.shape)
    curv = diff * diff
    idx = jnp.arange(n)
    interior = (idx >= half_window) & (idx < count[..., None] - half_window)
    return jnp.where(interior, curv, 0.0), order, count


def extract_corner_features(scan: Scan, cfg: FeatureConfig) -> jax.Array:
    """Select corner beams; returns a bool mask (..., N) over original beams.

    Reproduces feature_detection.cc:139-171: the compacted scan is split into
    ``num_sectors`` equal index ranges; in each, the ``max_per_sector``
    highest-curvature beams with curvature > threshold are kept.
    """
    n = scan.num_beams
    curv, order, count = curvature_compacted(
        scan.ranges, scan.valid, cfg.half_window
    )
    idx = jnp.arange(n)
    eligible = curv > cfg.curvature_threshold
    cnt = count[..., None]

    def per_sector(s):
        # reference boundaries (:141-148): start=count*j//S,
        # end=count*(j+1)//S - 1 inclusive; sector skipped if start >= end
        start = cnt * s // cfg.num_sectors
        end = cnt * (s + 1) // cfg.num_sectors - 1
        member = (idx >= start) & (idx <= end) & (start < end)
        score = jnp.where(eligible & member, curv, -jnp.inf)
        # top-k over the beam axis, batched over leading axes
        topv, topi = jax.lax.top_k(score, cfg.max_per_sector)
        keep = topv > -jnp.inf
        sel = jnp.zeros(curv.shape, dtype=bool)
        sel = jnp.put_along_axis(
            sel, topi, keep, axis=-1, inplace=False, mode="drop"
        )
        return sel

    selected = jnp.zeros(curv.shape, dtype=bool)
    for s in range(cfg.num_sectors):
        selected = selected | per_sector(s)

    # scatter back: selected is in compacted order → original beam index mask
    mask = jnp.zeros_like(selected)
    mask = jnp.put_along_axis(
        mask, order, selected, axis=-1, inplace=False
    )
    return mask & scan.valid


def feature_scan(scan: Scan, cfg: FeatureConfig) -> Scan:
    """The republished sparse `corner_scan` (:152-176): same scan with
    validity restricted to corner beams."""
    mask = extract_corner_features(scan, cfg)
    return scan.replace(valid=mask)
