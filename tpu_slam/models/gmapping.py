"""GMapping-style hit/visit-count map builder.

Equivalent of the lesson4 gmapping node
(`lesson4/src/gmapping/gmapping.cc:87-242`): each scan's beams update
hit/visit counters (Bresenham free rays + endpoint hits, no pose
estimation — poses are provided), occupancy = hits/visits thresholded at
0.25 (:146-158). The reference's hierarchical 32×32 patch allocation
(`grid/harray2d.h:30-71`) is a CPU memory optimization with no device
analogue — a flat counter array with masked scatters covers the same
semantics.

The reference takes 0.39-0.41 s per scan on a 1600×1600 grid (SURVEY §6);
here a scan is two scatter-adds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam import geometry as geo
from tpu_slam.config import SLAMConfig
from tpu_slam.data.scan import Scan, index_scan
from tpu_slam.ops import gridmap as gm


class GMapping:
    def __init__(self, cfg: SLAMConfig):
        self.cfg = cfg
        g = cfg.grid
        self.hits = jnp.zeros((g.size_y * g.size_x,), jnp.int32)
        self.visits = jnp.zeros((g.size_y * g.size_x,), jnp.int32)
        # PointAccumulator acc field (grid/map.h:17-48): per-cell sum of hit
        # world positions; cell_means() = acc / hits
        self.acc = jnp.zeros((g.size_y * g.size_x, 2), jnp.float32)

        @jax.jit
        def _update(hits, visits, acc, pose, pts, valid):
            wp = geo.apply(pose, pts)
            return gm.counts_update_scan(
                hits, visits, g, pose[:2], wp, valid,
                max_range=cfg.scan.range_max, acc=acc,
            )

        self._update = _update

    def add_scan(self, scan: Scan, pose) -> None:
        pts = scan.points()
        valid = scan.valid & jnp.all(jnp.isfinite(pts), axis=-1)
        pts = jnp.where(valid[..., None], pts, 0.0)
        self.hits, self.visits, self.acc = self._update(
            self.hits, self.visits, self.acc,
            jnp.asarray(pose, jnp.float32), pts, valid,
        )

    def cell_means(self) -> np.ndarray:
        """Per-cell mean hit position (PointAccumulator::mean) as
        (size_y, size_x, 2) world coordinates; 0 where no hits."""
        g = self.cfg.grid
        return np.asarray(gm.counts_mean(self.acc, self.hits)).reshape(
            g.size_y, g.size_x, 2
        )

    def run(self, scans: Scan, poses: np.ndarray) -> None:
        for t in range(scans.ranges.shape[0]):
            self.add_scan(index_scan(scans, t), poses[t])

    def to_ros_map(self) -> np.ndarray:
        """int8 map: occupied(100) iff visits>0 ∧ hits/visits > threshold;
        free(0) iff visited; unknown(-1) otherwise (gmapping.cc:141-159)."""
        g = self.cfg.grid
        frac = gm.counts_occupancy(self.hits, self.visits)
        visited = self.visits > 0
        occ = visited & (frac > self.cfg.gmapping.occupancy_threshold)
        out = jnp.where(occ, 100, jnp.where(visited, 0, -1)).astype(jnp.int8)
        return np.asarray(out).reshape(g.size_y, g.size_x)
