"""Scan containers — fixed-shape, batch-first pytrees.

Replaces `sensor_msgs::LaserScan` ingestion (`lesson1/src/laser_scan_node.cc:47-82`),
the `LDP` conversion (`lesson3/src/scan_match_plicp.cc` LaserScanToLDP), and
`karto::LocalizedRangeScan` (Karto.h:5171-5470). All arrays have static shapes:
invalid beams are masked, never dropped, so every scan in a batch has the same
``num_beams`` and XLA sees one compiled shape.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tpu_slam import geometry
from tpu_slam.config import ScanConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scan:
    """A batch of laser scans.

    Leading axes are batch axes; the last axis is the beam axis of size N.

    Attributes:
      ranges: (..., N) measured ranges in meters; invalid beams hold any value.
      valid: (..., N) bool — range_min < r < range_max and finite
             (scan_to_pointclod2_converter.cc:57-66 validity window).
      angles: (..., N) beam angles in the laser frame.
      stamp: (...,) scan start time in seconds.
      time_increment: (...,) seconds between consecutive beams
             (lesson5/src/lidar_undistortion.cc:154-156 time window).
    """

    ranges: jax.Array
    valid: jax.Array
    angles: jax.Array
    stamp: jax.Array
    time_increment: jax.Array

    def replace(self, **changes) -> "Scan":
        return dataclasses.replace(self, **changes)

    @property
    def num_beams(self) -> int:
        return self.ranges.shape[-1]

    def points(self) -> jax.Array:
        """Polar→Cartesian endpoints in the laser frame, (..., N, 2).

        The per-beam conversion of laser_scan_node.cc:73-79 and
        LaserScanToLDP, vectorized. Invalid beams produce garbage values that
        must be gated with ``self.valid``.
        """
        x = self.ranges * jnp.cos(self.angles)
        y = self.ranges * jnp.sin(self.angles)
        return jnp.stack([x, y], axis=-1)

    def beam_times(self) -> jax.Array:
        """Per-beam absolute timestamps, (..., N)."""
        n = self.num_beams
        idx = jnp.arange(n, dtype=self.ranges.dtype)
        return self.stamp[..., None] + self.time_increment[..., None] * idx


def make_scan(
    ranges,
    cfg: ScanConfig,
    stamp=0.0,
    dtype=jnp.float32,
) -> Scan:
    """Build a Scan (or batch) from raw range arrays + sensor config."""
    ranges = jnp.asarray(ranges, dtype=dtype)
    batch_shape = ranges.shape[:-1]
    n = ranges.shape[-1]
    angles = cfg.angle_min + cfg.angle_increment * jnp.arange(n, dtype=dtype)
    angles = jnp.broadcast_to(angles, ranges.shape)
    valid = (
        jnp.isfinite(ranges)
        & (ranges > cfg.range_min)
        & (ranges < cfg.range_max)
    )
    stamp = jnp.broadcast_to(jnp.asarray(stamp, dtype=dtype), batch_shape)
    tinc = jnp.broadcast_to(
        jnp.asarray(cfg.scan_period / max(n, 1), dtype=dtype), batch_shape
    )
    return Scan(
        ranges=ranges, valid=valid, angles=angles, stamp=stamp,
        time_increment=tinc,
    )


def world_points(scan: Scan, pose: jax.Array) -> jax.Array:
    """Scan endpoints in the world frame given sensor pose(s).

    `LocalizedRangeScan::Update`'s world-point readings (Karto.h:5398-5440).
    pose: (..., 3) broadcastable against the scan batch.
    """
    return geometry.apply(pose, scan.points())


def stack_scans(scans: list[Scan]) -> Scan:
    """Stack a list of equally-shaped scans into a leading batch axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, axis=0), *scans)


def index_scan(batch: Scan, i) -> Scan:
    """Select scan(s) i from the leading batch axis."""
    return jax.tree_util.tree_map(lambda x: x[i], batch)
