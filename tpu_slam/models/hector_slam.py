"""Hector SLAM: multi-resolution scan-to-map GN matching + log-odds mapping.

Re-design of `lesson4/src/hector_mapping/hector_slam.cc:26-362`
(HectorMappingRos) + `slam_main/HectorSlamProcessor.h:81-108`:

  update(scan):
    1. coarse-to-fine GN match against the map pyramid  (ops/hector.py)
    2. if moved > (0.4 m, 0.13 rad): update every level  (ops/gridmap.py)

Unlike the reference's per-level `GridMap` objects with mutexes and per-scan
caches, each level here is a flat device array; the per-level maps are
updated independently per scan exactly like MapRepMultiMap::updateByScan
(MapRepMultiMap.h:174-195). The map-publish path is `to_ros_map()` — one
device op instead of the reference's ~50 ms conversion loop.

Also covers the lesson4 `hector_mapping` map-only node (#9, SURVEY §2.1):
construct with ``match=False`` usage via `update_only`.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam import geometry as geo
from tpu_slam.config import GridConfig, SLAMConfig
from tpu_slam.data.scan import Scan, index_scan
from tpu_slam.ops import gridmap as gm
from tpu_slam.ops.hector import match_multires


def build_pyramid_cfgs(cfg: SLAMConfig) -> list[GridConfig]:
    """Level i: resolution ×2^i, cell count /2^i, same world footprint
    (MapRepMultiMap.h:57-90)."""
    h = cfg.hector
    out = []
    res = h.map_resolution
    size = h.map_size
    # world origin chosen so the start position sits at (start_x, start_y)
    # normalized map coords (hector_slam.cc mapStart params)
    origin_x = -size * res * h.map_start_x
    origin_y = -size * res * h.map_start_y
    for i in range(h.map_multi_res_levels):
        out.append(
            GridConfig(
                resolution=res,
                size_x=size,
                size_y=size,
                origin_x=origin_x,
                origin_y=origin_y,
            )
        )
        res *= 2.0
        size //= 2
    return out


class HectorSLAM:
    def __init__(self, cfg: SLAMConfig, mesh=None):
        """``mesh``: optional jax.sharding.Mesh — the map pyramid is then
        row-stripe-sharded over the mesh (SURVEY §2.5 spatial parallelism,
        the sharded analogue of the reference's one flat mapArray,
        GridMapBase.h:401): matching runs the halo-exchange GN programs and
        updates the no-communication sharded rasterizer from
        parallel/sharded_map.py. Every pyramid level's size_y must divide
        by the mesh size."""
        self.cfg = cfg
        self.mesh = mesh
        self.grid_cfgs = build_pyramid_cfgs(cfg)
        self.locfg = dataclasses.replace(
            cfg.logodds,
            p_free=cfg.hector.update_factor_free,
            p_occupied=cfg.hector.update_factor_occupied,
        )
        self.grids = [
            jnp.zeros((g.size_y * g.size_x,), jnp.float32)
            for g in self.grid_cfgs
        ]
        self.last_pose = jnp.zeros(3, jnp.float32)
        self._last_map_update_pose = None
        self.last_cov = np.zeros((3, 3))

        hcfg = cfg.hector
        gcfgs = tuple(self.grid_cfgs)

        if mesh is not None:
            self._build_sharded(mesh, gcfgs, hcfg)
            return

        @jax.jit
        def _match(grids, pose, pts, valid):
            probs = [gm.occupancy_prob(g) for g in grids]
            return match_multires(probs, gcfgs, pose, pts, valid, hcfg)

        @jax.jit
        def _update(grids, pose, pts, valid):
            out = []
            for g, gc in zip(grids, gcfgs):
                wp = geo.apply(pose, pts)
                out.append(
                    gm.logodds_update_scan(
                        g, gc, self.locfg, pose[:2], wp, valid,
                        max_range=cfg.scan.range_max,
                    )
                )
            return out

        self._match_fn = _match
        self._update_fn = _update

    def _build_sharded(self, mesh, gcfgs, hcfg):
        """Mesh path: per-level halo-exchange GN match + sharded log-odds
        rasterization (stripes never leave their device inside a launch;
        grids are stored flat between launches so the rest of the class is
        layout-agnostic)."""
        from tpu_slam.parallel.sharded_map import (
            make_sharded_hector_step,
            make_sharded_logodds_update,
        )
        from tpu_slam.ops.hector import map_pose_to_world, world_pose_to_map

        max_range = float(self.cfg.scan.range_max)
        matchers = [
            make_sharded_hector_step(
                mesh, gc,
                max_rot_step=hcfg.max_rot_step,
                # 1 + iterations GN steps (ScanMatcher.h:73-86, the
                # estimateTransformationLogLh-then-numIter loop)
                n_iters=1 + (
                    hcfg.iterations_fine if lvl == 0
                    else hcfg.iterations_coarse
                ),
            )
            for lvl, gc in enumerate(gcfgs)
        ]
        updaters = [
            make_sharded_logodds_update(mesh, gc, self.locfg, max_range)
            for gc in gcfgs
        ]
        probs = [
            jax.jit(
                lambda g, gc=gc: gm.occupancy_prob(g).reshape(
                    gc.size_y, gc.size_x
                )
            )
            for gc in gcfgs
        ]

        def _match(grids, pose, pts, valid):
            # coarse→fine over levels (match_multires semantics); one
            # sharded launch per level, pose conversions between launches
            H = None
            for lvl in range(len(gcfgs) - 1, -1, -1):
                gc = gcfgs[lvl]
                pose_map = world_pose_to_map(gc, pose)
                pose_map, H = matchers[lvl](
                    probs[lvl](grids[lvl]), pose_map,
                    pts / gc.resolution, valid,
                )
                # final-angle normalization (match_level's tail)
                pose_map = jnp.concatenate(
                    [
                        pose_map[:2],
                        geo.normalize_angle(pose_map[2])[None],
                    ]
                )
                pose = map_pose_to_world(gc, pose_map)
            return pose, H

        def _update(grids, pose, pts, valid):
            wp = geo.apply(pose, pts)
            out = []
            for lvl, gc in enumerate(gcfgs):
                g = updaters[lvl](
                    grids[lvl].reshape(gc.size_y, gc.size_x),
                    pose[:2], wp, valid,
                )
                out.append(g.reshape(-1))
            return out

        self._match_fn = _match
        self._update_fn = _update

    def _moved_enough(self, pose: np.ndarray) -> bool:
        """poseDifferenceLargerThan (HectorSlamProcessor update gate)."""
        if self._last_map_update_pose is None:
            return True
        d = pose - self._last_map_update_pose
        h = self.cfg.hector
        ang = abs(float(geo.normalize_angle(jnp.asarray(d[2]))))
        return (
            np.hypot(d[0], d[1]) > h.map_update_distance_thresh
            or ang > h.map_update_angle_thresh
        )

    def update_only(self, scan: Scan, pose) -> None:
        """Map update with a given pose, no matching — the lesson4
        hector_mapping node's updateByScanJustOnce path
        (hector_mapping.cc:82-211)."""
        pts = jnp.where(
            scan.valid[..., None] & jnp.isfinite(scan.points()),
            scan.points(), 0.0,
        )
        pose = jnp.asarray(pose, jnp.float32)
        self.grids = self._update_fn(self.grids, pose, pts, scan.valid)
        self._last_map_update_pose = np.array(pose)
        self.last_pose = pose

    def step(self, scan: Scan, map_without_matching: bool = False) -> np.ndarray:
        """HectorSlamProcessor::update (HectorSlamProcessor.h:81-108)."""
        pts = jnp.where(
            scan.valid[..., None] & jnp.isfinite(scan.points()),
            scan.points(), 0.0,
        )
        valid = scan.valid & jnp.all(jnp.isfinite(scan.points()), axis=-1)

        if map_without_matching or self._last_map_update_pose is None:
            new_pose = self.last_pose
        else:
            new_pose, H = self._match_fn(
                self.grids, self.last_pose, pts, valid
            )
            self.last_cov = np.asarray(H)  # covMatrix ≈ H (ScanMatcher.h:90)

        pose_np = np.array(new_pose)
        if self._moved_enough(pose_np):
            self.grids = self._update_fn(self.grids, new_pose, pts, valid)
            self._last_map_update_pose = pose_np
        self.last_pose = new_pose
        return pose_np

    def sampling_covariance(self, scan: Scan, level: int = 0) -> np.ndarray:
        """Sampling-based covariance of `last_pose` at a pyramid level
        (getCovarianceForPose, OccGridMapUtil.h:249-306) — the reference's
        alternative to the H≈cov estimate stored in `last_cov`. Returned in
        WORLD units (the reference leaves it in map cells)."""
        from tpu_slam.ops import gridmap as gm
        from tpu_slam.ops.hector import (
            sampling_covariance, world_pose_to_map,
        )

        gc = self.grid_cfgs[level]
        p = scan.points()
        finite = jnp.isfinite(p)
        pts = jnp.where(scan.valid[..., None] & finite, p, 0.0)
        valid = scan.valid & jnp.all(finite, axis=-1)
        cov_map = sampling_covariance(
            gm.occupancy_prob(self.grids[level]), gc.size_x, gc.size_y,
            world_pose_to_map(gc, self.last_pose),
            pts / gc.resolution, valid,
        )
        # map cells → meters on the translation rows/cols
        s = np.array([gc.resolution, gc.resolution, 1.0])
        return np.asarray(cov_map) * np.outer(s, s)

    def run(self, scans: Scan) -> np.ndarray:
        T = scans.ranges.shape[0]
        out = np.zeros((T, 3))
        for t in range(T):
            out[t] = self.step(index_scan(scans, t))
        return out

    def to_ros_map(self, level: int = 0) -> np.ndarray:
        """int8 occupancy map of a pyramid level (publishMap analogue)."""
        g = self.grid_cfgs[level]
        return np.asarray(
            gm.logodds_to_ros(
                self.grids[level],
                self.cfg.logodds.obstacle_threshold,
            )
        ).reshape(g.size_y, g.size_x)
