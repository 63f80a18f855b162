"""ctypes bindings for the native host-side components.

Builds `libslam2d_native.so` from tpu_slam_native.cpp on first use (g++,
-O3 -march=native); everything degrades gracefully to the numpy fallbacks if
no compiler is available (``available()`` reports the state).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "tpu_slam_native.cpp")
_SO = os.path.join(_DIR, "libslam2d_native.so")

_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            [
                "g++", "-O3", "-march=native", "-shared", "-fPIC",
                "-std=c++17", _SRC, "-o", _SO,
            ],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
        _SRC
    ):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    fp = ctypes.POINTER(ctypes.c_float)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.c_int64
    cs = ctypes.c_char_p
    lib.ts_raycast.argtypes = [dp, i64, dp, dp, i64, ctypes.c_double, dp]
    lib.ts_bresenham_masks.argtypes = [dp, dp, u8, i64, i64, i64, u8, u8]
    lib.ts_decimate.argtypes = [fp, i64, i64, fp]
    lib.ts_bag_count.argtypes = [cs, cs, ctypes.POINTER(i64)]
    lib.ts_bag_count.restype = i64
    lib.ts_bag_read_scans.argtypes = [cs, cs, i64, i64, fp, dp, dp]
    lib.ts_bag_read_scans.restype = i64
    lib.ts_bag_read_imu.argtypes = [cs, cs, i64, dp, dp, dp]
    lib.ts_bag_read_imu.restype = i64
    lib.ts_bag_read_odom.argtypes = [cs, cs, i64, dp, dp, dp]
    lib.ts_bag_read_odom.restype = i64
    i32 = ctypes.POINTER(ctypes.c_int32)
    f32 = ctypes.c_float
    lib.ts_karto_counts.argtypes = [
        fp, fp, fp, i64, i64, f32, f32, f32, i64, i64, f32, f32, f32,
        i32, i32,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def raycast(segments: np.ndarray, origins: np.ndarray, angles: np.ndarray,
            range_max: float) -> np.ndarray:
    """Native batched ray/segment intersection (data/simulator.py fallback)."""
    lib = _load()
    seg = np.ascontiguousarray(segments, np.float64)
    org = np.ascontiguousarray(origins, np.float64)
    ang = np.ascontiguousarray(angles, np.float64)
    out = np.empty(len(ang), np.float64)
    if lib is None:
        from tpu_slam.data.simulator import World, raycast as np_raycast

        return np_raycast(World(seg), org, ang, range_max)
    lib.ts_raycast(
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(seg),
        org.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ang.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(ang),
        float(range_max),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def bresenham_masks(origin_cell: np.ndarray, end_cells: np.ndarray,
                    valid: np.ndarray, w: int, h: int):
    """Reference-exact Bresenham (free, occ) masks — the golden CPU check
    for ops/gridmap.scan_masks. Requires the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    oc = np.ascontiguousarray(origin_cell, np.float64)
    ec = np.ascontiguousarray(end_cells, np.float64)
    v = np.ascontiguousarray(valid, np.uint8)
    free = np.zeros(w * h, np.uint8)
    occ = np.zeros(w * h, np.uint8)
    u8p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    dp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    lib.ts_bresenham_masks(
        dp(oc), dp(ec), u8p(v), len(ec), w, h, u8p(free), u8p(occ)
    )
    return free.reshape(h, w).astype(bool), occ.reshape(h, w).astype(bool)


def karto_counts(origins: np.ndarray, endpoints: np.ndarray,
                 ranges: np.ndarray, grid_cfg, range_threshold: float,
                 min_range: float = 0.0,
                 max_range: float = np.inf) -> tuple[np.ndarray, np.ndarray]:
    """Whole-mission Karto pass/hit counters (CreateFromScans) on the host.

    EXACT reference semantics (Karto.h:5886-5950), mirroring
    ops/gridmap.karto_counts_update_scan: Bresenham TraceLine inclusive of
    the endpoint, valid endpoints (r < threshold - 1e-6) double-count pass
    + hit, rays clamped at the threshold, r<=min / r>=max / NaN skipped.
    Returns (pass_cnt, hit_cnt) int32 (H, W)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    org = np.ascontiguousarray(origins, np.float32)
    ends = np.ascontiguousarray(endpoints, np.float32)
    r = np.ascontiguousarray(ranges, np.float32)
    T, N = r.shape
    H, W = grid_cfg.size_y, grid_cfg.size_x
    pc = np.zeros(H * W, np.int32)
    hc = np.zeros(H * W, np.int32)
    i32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    lib.ts_karto_counts(
        _fp(org), _fp(ends), _fp(r),
        T, N,
        float(grid_cfg.resolution), float(grid_cfg.origin_x),
        float(grid_cfg.origin_y), W, H,
        float(range_threshold), float(min_range), float(max_range),
        i32p(pc), i32p(hc),
    )
    return pc.reshape(H, W), hc.reshape(H, W)


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decimate(ranges: np.ndarray, factor: int) -> np.ndarray:
    """Min-filter beam decimation."""
    lib = _load()
    r = np.ascontiguousarray(ranges, np.float32)
    if lib is None:
        m = len(r) // factor
        return r[: m * factor].reshape(m, factor).min(axis=1)
    out = np.empty(len(r) // factor, np.float32)
    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.ts_decimate(fp(r), len(r), factor, fp(out))
    return out


def _dp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def bag_read_scans(path: str, topic: str):
    """Native bulk LaserScan decode: (ranges (M, N) f32, stamps (M,) f64,
    meta dict). Returns None when the native path can't handle the bag
    (library unavailable / bz2 chunks without libbz2) — caller falls back
    to the pure-python reader."""
    lib = _load()
    if lib is None:
        return None
    beams = ctypes.c_int64(0)
    n = lib.ts_bag_count(path.encode(), topic.encode(), ctypes.byref(beams))
    if n < 0 or beams.value <= 0:
        return None
    ranges = np.empty((n, beams.value), np.float32)
    stamps = np.empty(n, np.float64)
    meta = np.zeros(7, np.float64)
    got = lib.ts_bag_read_scans(
        path.encode(), topic.encode(), n, beams.value,
        ranges.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        _dp(stamps), _dp(meta),
    )
    if got < 0:
        return None
    keys = (
        "angle_min", "angle_max", "angle_increment", "time_increment",
        "scan_time", "range_min", "range_max",
    )
    return (
        ranges[:got],
        stamps[:got],
        {k: float(v) for k, v in zip(keys, meta)},
    )


def bag_read_imu(path: str, topic: str):
    """Native bulk Imu decode: (stamps, yaw, gyro (M, 3)) or None."""
    lib = _load()
    if lib is None:
        return None
    beams = ctypes.c_int64(0)
    n = lib.ts_bag_count(path.encode(), topic.encode(), ctypes.byref(beams))
    if n < 0:
        return None
    stamps = np.empty(n, np.float64)
    yaw = np.empty(n, np.float64)
    gyro = np.empty((n, 3), np.float64)
    got = lib.ts_bag_read_imu(
        path.encode(), topic.encode(), n, _dp(stamps), _dp(yaw), _dp(gyro)
    )
    if got < 0:
        return None
    return stamps[:got], yaw[:got], gyro[:got]


def bag_read_odom(path: str, topic: str):
    """Native bulk Odometry decode: (stamps, pose (M, 3), twist (M, 3))
    or None."""
    lib = _load()
    if lib is None:
        return None
    beams = ctypes.c_int64(0)
    n = lib.ts_bag_count(path.encode(), topic.encode(), ctypes.byref(beams))
    if n < 0:
        return None
    stamps = np.empty(n, np.float64)
    pose = np.empty((n, 3), np.float64)
    twist = np.empty((n, 3), np.float64)
    got = lib.ts_bag_read_odom(
        path.encode(), topic.encode(), n, _dp(stamps), _dp(pose), _dp(twist)
    )
    if got < 0:
        return None
    return stamps[:got], pose[:got], twist[:got]
