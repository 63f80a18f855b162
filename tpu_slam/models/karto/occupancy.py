"""Occupancy-grid generation from all corrected scans.

The `updateMap` path of the karto node (`lesson6/src/karto_slam.cc:507-581`)
+ `karto::OccupancyGrid::CreateFromScans` (Karto.h:5659-6039): whenever the
map is requested, ray-trace EVERY stored scan from its corrected pose into
pass/hit counters and threshold. The reference rebuilds at <1 Hz on CPU
(SURVEY §6 ~0.09 s for 4M cells before ray tracing); here each scan is two
scatter-adds on device and the loop is a `lax.scan` over the stacked scan
store.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam import geometry as geo
from tpu_slam.config import GridConfig
from tpu_slam.ops import gridmap as gm


def compute_grid_bounds(
    poses: np.ndarray, range_threshold: float, resolution: float,
    margin: float = 0.5,
) -> GridConfig:
    """Auto-size the grid to cover all scans (conservative pose±threshold
    box; see karto_grid_bounds for the reference-exact geometry)."""
    lo = poses[:, :2].min(axis=0) - range_threshold - margin
    hi = poses[:, :2].max(axis=0) + range_threshold + margin
    size_x = int(math.ceil((hi[0] - lo[0]) / resolution))
    size_y = int(math.ceil((hi[1] - lo[1]) / resolution))
    return GridConfig(
        resolution=resolution,
        size_x=size_x,
        size_y=size_y,
        origin_x=float(lo[0]),
        origin_y=float(lo[1]),
    )


def karto_grid_bounds(
    poses: np.ndarray,
    pts_laser: np.ndarray,
    ranges: np.ndarray,
    min_range: float,
    range_threshold: float,
    resolution: float,
) -> GridConfig:
    """The reference's exact grid geometry (ComputeDimensions,
    Karto.h:5812-5831): bounding box of every scan's position + FILTERED
    point readings (InRange(r, min, threshold), Karto.h:5381); width/height
    = Round(size·scale), offset = box minimum. Computed in f64."""
    p64 = np.asarray(poses, np.float64)
    c = np.cos(p64[:, 2])[:, None]
    s = np.sin(p64[:, 2])[:, None]
    pl = np.asarray(pts_laser, np.float64)
    wx = p64[:, 0:1] + c * pl[..., 0] - s * pl[..., 1]
    wy = p64[:, 1:2] + s * pl[..., 0] + c * pl[..., 1]
    r = np.asarray(ranges, np.float64)
    filt = np.isfinite(r) & (r >= min_range) & (r <= range_threshold)
    xs = np.concatenate([p64[:, 0], wx[filt]])
    ys = np.concatenate([p64[:, 1], wy[filt]])
    lo = np.array([xs.min(), ys.min()])
    hi = np.array([xs.max(), ys.max()])

    def _round(v):
        return int(math.floor(v + 0.5) if v >= 0 else math.ceil(v - 0.5))

    return GridConfig(
        resolution=resolution,
        size_x=_round((hi[0] - lo[0]) / resolution),
        size_y=_round((hi[1] - lo[1]) / resolution),
        origin_x=float(lo[0]),
        origin_y=float(lo[1]),
    )


def occupancy_from_scans(
    grid_cfg: GridConfig,
    poses: np.ndarray,  # (T, 3) corrected sensor poses
    pts_laser: np.ndarray,  # (T, N, 2)
    ranges: np.ndarray,  # (T, N) raw readings
    range_threshold: float,
    min_range: float = 0.0,
    max_range: float = np.inf,
    min_pass_through: int = 2,
    occupancy_threshold: float = 0.1,
    scans_per_block: int = 1,
    engine: str = "auto",
) -> np.ndarray:
    """CreateFromScans: returns int8 (H, W) map (-1 unknown/0 free/100 occ).

    EXACT reference semantics (AddScan→RayTrace→UpdateCell,
    Karto.h:5886-5968): rays skip r≤min / r≥max / NaN, clamp at the range
    threshold, TraceLine (Bresenham, endpoint-inclusive) increments pass,
    valid endpoints (r < threshold − 1e-6) add one more pass + a hit;
    occupied iff pass > MinPassThrough ∧ hit/pass > OccupancyThreshold.
    Validated cell-identical vs the compiled reference
    (tests/test_golden_karto.py::test_golden_occupancy_grid).

    engine: "device" (per-scan window one-hot rasterization,
    gm.karto_counts_windows — the scatter-free device path), "device-scatter"
    (XLA scatter loop over closed-form Bresenham cells), "native" (the C++
    host rasterizer `native.karto_counts`, same semantics), or "auto"
    (native when available, else device).

    scans_per_block: scans rasterized per scatter op of the
    "device-scatter" engine.
    """
    ncells = grid_cfg.size_y * grid_cfg.size_x
    T = poses.shape[0]
    if T == 0:
        return np.full((grid_cfg.size_y, grid_cfg.size_x), -1, np.int8)

    if engine == "auto":
        # map regeneration is a host-side byte-twiddling workload, not a
        # matmul: the native C++ rasterizer is preferred (cell-identical
        # outputs). Device paths remain for hosts without the native
        # library and for sharded-map pipelines. Which wins on a GPU is
        # not measured yet.
        engine = "native-or-device"

    if engine == "device":
        p32 = jnp.asarray(poses, jnp.float32)

        @jax.jit
        def build_w(poses_d, pts_d, r_d):
            wp = geo.apply(poses_d[:, None, :], pts_d)
            pc, hc = gm.karto_counts_windows(
                grid_cfg, poses_d[:, :2], wp, r_d, range_threshold,
                min_range, max_range,
            )
            return gm.karto_occupancy(
                pc.reshape(-1), hc.reshape(-1),
                min_pass_through, occupancy_threshold,
            )

        out = build_w(
            p32, jnp.asarray(pts_laser, jnp.float32),
            jnp.asarray(ranges, jnp.float32),
        )
        return np.asarray(out).reshape(grid_cfg.size_y, grid_cfg.size_x)

    if engine in ("native", "native-or-device"):
        from tpu_slam import native

        if native.available():
            # world endpoints from corrected poses (host, float32)
            p32 = np.asarray(poses, np.float32)
            c = np.cos(p32[:, 2])[:, None]
            s = np.sin(p32[:, 2])[:, None]
            pl32 = np.asarray(pts_laser, np.float32)
            with np.errstate(invalid="ignore"):
                wx = p32[:, 0:1] + c * pl32[..., 0] - s * pl32[..., 1]
                wy = p32[:, 1:2] + s * pl32[..., 0] + c * pl32[..., 1]
            ends = np.stack([wx, wy], axis=-1)
            pc, hc = native.karto_counts(
                p32[:, :2], ends, np.asarray(ranges, np.float32), grid_cfg,
                range_threshold, min_range, max_range,
            )
            passed = pc > min_pass_through
            occ = passed & (
                hc / np.maximum(pc, 1) > occupancy_threshold
            )
            return np.where(occ, 100, np.where(passed, 0, -1)).astype(
                np.int8
            )
        if engine == "native":
            raise RuntimeError("native library unavailable")
    # fallthrough: "device-scatter" (and native-or-device without the lib)
    C = min(scans_per_block, T)
    pad = (-T) % C
    if pad:
        poses = np.concatenate([poses, np.zeros((pad, 3), poses.dtype)])
        pts_laser = np.concatenate(
            [pts_laser, np.zeros((pad,) + pts_laser.shape[1:],
                                 pts_laser.dtype)]
        )
        ranges = np.concatenate(
            [ranges, np.full((pad,) + ranges.shape[1:], np.nan,
                             ranges.dtype)]
        )
    TB = (T + pad) // C

    @jax.jit
    def build(poses_d, pts_d, r_d):
        def body(carry, inp):
            p, h = carry
            pose, pts, r = inp  # (C, 3), (C, N, 2), (C, N)
            wp = geo.apply(pose, pts)
            p, h = gm.karto_counts_update_scan(
                p, h, grid_cfg, pose[:, :2], wp, r, range_threshold,
                min_range, max_range,
            )
            return (p, h), None

        init = (
            jnp.zeros((ncells,), jnp.int32),
            jnp.zeros((ncells,), jnp.int32),
        )
        (p, h), _ = jax.lax.scan(body, init, (poses_d, pts_d, r_d))
        return gm.karto_occupancy(
            p, h, min_pass_through, occupancy_threshold
        )

    out = build(
        jnp.asarray(poses, jnp.float32).reshape(TB, C, 3),
        jnp.asarray(pts_laser, jnp.float32).reshape(
            TB, C, *pts_laser.shape[1:]
        ),
        jnp.asarray(ranges, jnp.float32).reshape(TB, C, *ranges.shape[1:]),
    )
    return np.asarray(out).reshape(grid_cfg.size_y, grid_cfg.size_x)


def karto_map(slam, resolution: float = 0.05) -> tuple[np.ndarray, GridConfig]:
    """updateMap for a KartoSLAM instance: auto-bounded map from all scans
    (karto_slam.cc:507-581 → OccupancyGrid::CreateFromScans)."""
    slam.flush()  # apply any in-flight async correction first
    # rasterize from corrected SENSOR poses — pts_laser are laser-frame, so
    # the rig offset must stay applied (GetSensorPose, Karto.h:5331-5345);
    # trajectory() would strip it
    poses = np.asarray([r.corrected_pose for r in slam.scans]).reshape(-1, 3)
    if len(poses) == 0:
        raise ValueError("no scans processed yet")
    sc = slam.cfg.scan
    pts = np.stack([r.pts_laser for r in slam.scans])
    ranges = np.stack(
        [
            r.ranges
            if r.ranges is not None
            # legacy checkpoints without stored ranges: reconstruct from the
            # endpoint norms (valid beams only)
            else np.where(
                r.beam_valid, np.hypot(r.pts_laser[:, 0], r.pts_laser[:, 1]),
                np.nan,
            )
            for r in slam.scans
        ]
    )
    cfg = karto_grid_bounds(
        poses, pts, ranges, sc.range_min, sc.range_threshold, resolution
    )
    return (
        occupancy_from_scans(
            cfg, poses, pts, ranges, sc.range_threshold,
            min_range=sc.range_min, max_range=sc.range_max,
        ),
        cfg,
    )


def karto_graph_png(
    slam, path: str, ros_map=None, grid: GridConfig = None,
    resolution: float = 0.05,
) -> str:
    """Write the pose-graph visualization for a KartoSLAM instance: nodes +
    sequential/chain/loop edges over the occupancy map (the rviz MarkerArray
    debugging artifact, karto_slam.cc:603-682). Reuses a precomputed
    (ros_map, grid) pair when given; otherwise rasterizes one."""
    from tpu_slam.utils.map_io import save_graph_png

    if ros_map is None or grid is None:
        ros_map, grid = karto_map(slam, resolution)
    poses = np.asarray([r.corrected_pose for r in slam.scans]).reshape(-1, 3)
    return save_graph_png(
        path, np.asarray(ros_map), grid, poses, slam.graph_edges
    )
