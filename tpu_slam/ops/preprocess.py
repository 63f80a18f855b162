"""Scan preprocessing: validity filtering + pointcloud conversion.

Equivalent of `lesson2/src/scan_to_pointclod2_converter.cc:44-92`
(LaserScan→PCL with NaN invalid points) and the per-beam polar→Cartesian demo
of `lesson1/src/laser_scan_node.cc:73-79`. Everything is masked fixed-shape
math — no compaction, no dynamic sizes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_slam.data.scan import Scan


def scan_to_pointcloud(scan: Scan, invalid_value: float = jnp.nan) -> jax.Array:
    """Convert scan(s) to (..., N, 3) xyz clouds; invalid beams get NaN.

    Mirrors the converter node's validity window + NaN fill
    (scan_to_pointclod2_converter.cc:57-76); z is always 0 for 2D scans.
    """
    pts = scan.points()
    xy = jnp.where(scan.valid[..., None], pts, invalid_value)
    z = jnp.zeros_like(xy[..., :1])
    return jnp.concatenate([xy, z], axis=-1)


def masked_points(scan: Scan) -> tuple[jax.Array, jax.Array]:
    """(points (..., N, 2), valid (..., N)) with invalid points zeroed.

    The standard input format for the matchers: zeroed invalid points are
    safe to feed through gathers/matmuls and are excluded by the mask.
    """
    pts = scan.points()
    return jnp.where(scan.valid[..., None], pts, 0.0), scan.valid


def compact_order(valid: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Stable order that brings valid beams to the front (static shape).

    The fixed-shape analogue of the reference's drop-invalid compaction
    (feature_detection.cc:93-106): ``order[j]`` is the original index of the
    j-th valid beam; ``count`` is the number of valid beams.
    """
    n = valid.shape[-1]
    key = jnp.where(valid, 0, 1) * n + jnp.arange(n)
    order = jnp.argsort(key, axis=-1)
    count = valid.sum(axis=-1)
    return order, count
