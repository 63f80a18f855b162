"""Karto correlative scan matcher as a tensor program.

Re-design of `karto::ScanMatcher` (`lesson6/lib/open_karto/src/
Mapper.cpp:126-856`, `include/open_karto/Mapper.h:900-1110`):

  * correlation grid: base-scan endpoints rasterized + Gaussian smear
    (AddScan/SmearPoint, Mapper.cpp:699-748 / Mapper.h:971-1087) — here one
    scatter-max of precomputed kernel patches around every endpoint.
  * search: the exhaustive triple loop over (x, y, θ) candidates
    (CorrelateScan, Mapper.cpp:309-424) becomes a gather over a
    (angles × offsets × beams) index tensor, chunked per angle.
  * response: Σ grid values at rotated beam cells / (nPoints·100)
    (GetResponse, Mapper.cpp:819-856). The grid stores the reference's
    quantized int kernel values (round(exp·100)), and numerators are summed
    in int32 — so response ties are EXACT, reproducing the reference's
    tie-averaged best pose (Mapper.cpp:455-487) bit-for-bit where it matters.
  * covariance: response-weighted second moments
    (ComputePositionalCovariance :535-633, ComputeAngularCovariance :641-693).

One parameter struct serves both the front-end matcher (0.3 m window) and
the loop-closure matcher (4–8 m window) — they are the same program with
different static shapes, as in the reference (two ScanMatcher instances).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam import geometry as geo

MAX_VARIANCE = 500.0  # Mapper.cpp:36
DISTANCE_PENALTY_GAIN = 0.2  # Mapper.cpp:37
ANGLE_PENALTY_GAIN = 0.2  # Mapper.cpp:38
KT_TOLERANCE = 1e-6
GRID_OCCUPIED = 100  # GridStates_Occupied


def kround(x):
    """math::Round (Math.h:87-90): round half AWAY from zero — NOT numpy's
    round-half-to-even. Grid parity with the reference depends on this at
    exact .5 cell boundaries."""
    return jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)


def kround_i(x):
    return kround(x).astype(jnp.int32)


def _pyround(x: float) -> int:
    """Host-side math::Round."""
    return int(math.floor(x + 0.5) if x >= 0.0 else math.ceil(x - 0.5))


def _align8(x: int) -> int:
    """math::AlignValue<8> (Math.h:244-247): grids store rows with an
    8-aligned stride; response index arithmetic follows it."""
    return (x + 7) & ~7


@dataclasses.dataclass(frozen=True)
class CorrelativeParams:
    """Static geometry of one matcher instance (ScanMatcher::Create,
    Mapper.cpp:126-173)."""

    search_size: float  # total search window (m); 0.3 front-end, 8.0 loop
    resolution: float  # correlation grid resolution
    smear_deviation: float
    range_threshold: float
    angle_offset: float  # coarse search half-window (rad)
    angle_res: float  # coarse angular step
    fine_angle_offset: float  # fine angular step (m_pFineSearchAngleOffset)
    distance_variance_penalty: float = 0.3**2
    angle_variance_penalty: float = math.radians(20.0) ** 2
    minimum_distance_penalty: float = 0.5
    minimum_angle_penalty: float = 0.9

    @property
    def n_search(self) -> int:
        # searchSpaceSideSize (Mapper.cpp:150)
        return _pyround(self.search_size / self.resolution) + 1

    @property
    def margin(self) -> int:
        # pointReadingMargin (Mapper.cpp:154)
        return int(math.ceil(self.range_threshold / self.resolution))

    @property
    def half_kernel(self) -> int:
        # GetHalfKernelSize (Mapper.h:1096-1101): 2σ, math::Round
        return _pyround(2.0 * self.smear_deviation / self.resolution)

    @property
    def grid_size(self) -> int:
        # roi + kernel border on each side (Mapper.h:928, :1016-1022)
        return self.n_search + 2 * self.margin + 2 * (self.half_kernel + 1)

    @property
    def row_stride(self) -> int:
        # m_WidthStep: 8-aligned row stride (Karto.h:4442). GetResponse adds
        # flat lookup offsets in this stride, so parity requires it.
        return _align8(self.grid_size)

    @property
    def center_cell(self) -> int:
        return self.grid_size // 2


def smear_kernel(params: CorrelativeParams) -> np.ndarray:
    """The reference's quantized Gaussian kernel (CalculateKernel,
    Mapper.h:1032-1094): int values Round(exp(-0.5 (d/σ)²)·100), computed in
    float64 exactly as the C++ does."""
    h = params.half_kernel
    ij = np.arange(-h, h + 1, dtype=np.float64)
    dx, dy = np.meshgrid(ij, ij, indexing="ij")
    d = np.hypot(dx * params.resolution, dy * params.resolution)
    z = np.exp(-0.5 * (d / params.smear_deviation) ** 2)
    return np.floor(z * GRID_OCCUPIED + 0.5).astype(np.int32)


def smear_lut(params: CorrelativeParams) -> np.ndarray:
    """Kernel value as a function of squared cell distance d² = i²+j²:
    LUT[d²] = Round(100·exp(-0.5·d²·(res/σ)²)) (f64, half-up — z ≥ 0).
    The kernel is radially monotone non-increasing, so the per-cell max over
    overlapping SmearPoint patches equals LUT[min d² to an occupied cell] —
    turning the smear into an int-exact separable squared-distance
    transform."""
    h = params.half_kernel
    d2 = np.arange(2 * h * h + 1, dtype=np.float64)
    z = np.exp(
        -0.5 * d2 * (params.resolution / params.smear_deviation) ** 2
    )
    return np.floor(z * GRID_OCCUPIED + 0.5).astype(np.int32)


def build_correlation_grid(
    params: CorrelativeParams,
    center_xy: jax.Array,
    pts: jax.Array,
    valid: jax.Array,
) -> jax.Array:
    """Rasterize base-scan world points around ``center_xy`` and smear.

    pts: (K, 2) world points (already view-filtered), valid: (K,).
    Returns int32 grid (G, W8) — W8 = 8-aligned row stride, right-padded
    with zeros like the reference's m_WidthStep layout — values 0..100.

    Smear parity (SmearPoint max-combining, Mapper.h:972-1009): each cell's
    value is the max kernel value over occupied cells in its window, i.e.
    LUT[min d²] by radial monotonicity. min d² = dx²+dy² is computed with
    the classic SEPARABLE two-pass squared-distance transform (2·(2h+1)
    static shifts, all int32 — bit-exact vs the C++ int kernel, unlike the
    earlier float max-dilation whose f32 exp could flip Round boundaries).
    """
    g = params.grid_size
    w8 = params.row_stride
    c = params.center_cell
    h = params.half_kernel
    lut = jnp.asarray(smear_lut(params))
    inf = jnp.int32(2 * h * h + 1)

    rel = (pts - center_xy) / params.resolution
    ix = kround_i(rel[..., 0]) + c
    iy = kround_i(rel[..., 1]) + c
    # ROI bounds check of AddScan (Mapper.cpp:723-730): border cells excluded
    inb = (ix >= h + 1) & (ix < g - h - 1) & (iy >= h + 1) & (iy < g - h - 1)
    OOB = g * w8 + 7
    flat = jnp.where(inb & valid, iy * w8 + ix, OOB)
    occ = jnp.zeros((g * w8,), bool).at[flat].max(True, mode="drop")
    occ = occ.reshape(g, w8)

    # pass 1: per-row min dx² to an occupied cell within |dx| ≤ h
    big = jnp.full((g, w8), inf, jnp.int32)
    pad = jnp.pad(occ, ((0, 0), (h, h)))
    rowd2 = big
    for j in range(2 * h + 1):
        dx2 = jnp.int32((j - h) * (j - h))
        rowd2 = jnp.minimum(
            rowd2, jnp.where(pad[:, j : j + w8], dx2, inf)
        )
    # pass 2: min over |dy| ≤ h of rowd2 + dy²
    pad2 = jnp.pad(rowd2, ((h, h), (0, 0)), constant_values=inf)
    d2 = big
    for i in range(2 * h + 1):
        dy2 = jnp.int32((i - h) * (i - h))
        d2 = jnp.minimum(d2, pad2[i : i + g, :] + dy2)
    vals = jnp.take(lut, jnp.clip(d2, 0, 2 * h * h), axis=0)
    return jnp.where(d2 <= 2 * h * h, vals, 0)


class CorrelateResult(NamedTuple):
    best_pose: jax.Array  # (3,) tie-averaged best pose (world)
    best_response: jax.Array  # scalar float
    search_probs: jax.Array  # (nY, nX) per-cell max response (coarse only)
    angle_responses: jax.Array  # (nA,) responses at the best cell


def _responses_for_angles(
    grid_flat,
    g: int,
    w8: int,
    pts_local,
    beam_valid,
    angles,
    cand_cells_flat,
    element_budget: int = 24_000_000,
):
    """Numerators (nA, nCand) of the correlation response, int32-exact.

    cand_cells_flat: (nCand,) flat grid index of each candidate position in
    the W8-strided layout. Beam cell offsets follow the reference's rounding
    of the rotated local point (GridIndexLookup::ComputeOffsets,
    Karto.h:6455-6500) with the 8-aligned stride and the IsUpTo bounds check
    of GetResponse (Mapper.cpp:843-848) — including the reference's
    row-wrap behavior for beams landing off the grid.

    The (angles × candidates × beams) gather tensor is fully vectorized when
    it fits ``element_budget``; beyond that (the 8 m loop matcher) angles are
    processed in groups via lax.map so peak memory stays bounded (a
    per-angle map would be 21 sequential, latency-bound steps).
    """
    nA = angles.shape[0]
    nC = cand_cells_flat.shape[0]
    N = pts_local.shape[0]
    size = g * w8

    def block(angs):  # (A,) → (A, nC) numerators
        c = jnp.cos(angs)[:, None]
        s = jnp.sin(angs)[:, None]
        rx = c * pts_local[None, :, 0] - s * pts_local[None, :, 1]
        ry = s * pts_local[None, :, 0] + c * pts_local[None, :, 1]
        off_flat = kround_i(ry) * w8 + kround_i(rx)  # (A, N)
        idx = cand_cells_flat[None, :, None] + off_flat[:, None, :]
        ok = beam_valid[None, None, :] & (idx >= 0) & (idx < size)
        vals = jnp.where(ok, grid_flat[jnp.clip(idx, 0, size - 1)], 0)
        return jnp.sum(vals, axis=-1)  # (A, nC)

    per = max(1, element_budget // max(nC * N, 1))
    if per >= nA:
        return block(angles)
    pad = (-nA) % per
    angs = jnp.concatenate([angles, jnp.zeros((pad,), angles.dtype)])
    groups = angs.reshape(-1, per)
    out = jax.lax.map(block, groups).reshape(-1, nC)
    return out[:nA]


def _lattice_stride(
    x_offsets: np.ndarray, y_offsets: np.ndarray, resolution: float
) -> int | None:
    """Integer cell stride of the candidate lattice, or None if the offsets
    are not a uniform lattice whose step is a whole number of grid cells on
    both axes (then the gather path must be used).

    Tolerances absorb float32 accumulation jitter in offset tables built as
    ``-half + i*step`` (a 1e-7-scale wobble must not silently kick the
    matcher onto the ~16x slower gather path)."""
    strides = []
    for off in (x_offsets, y_offsets):
        off = np.asarray(off, np.float64)
        if len(off) < 2:
            strides.append(1)
            continue
        k = (off[-1] - off[0]) / (len(off) - 1) / resolution
        ki = int(round(k))
        if ki < 1 or abs(k - ki) > 1e-3:
            return None
        # every offset must sit on the integer-stride lattice closely enough
        # that per-candidate rounding could not disagree with the lattice
        lattice = off[0] + np.arange(len(off)) * ki * resolution
        if np.max(np.abs(off - lattice)) > 0.05 * resolution:
            return None
        strides.append(ki)
    if strides[0] != strides[1]:
        return None
    return strides[0]


def _responses_sliced(
    grid,
    pts_cells,
    beam_valid,
    angles,
    cand0_xy,
    n_x: int,
    n_y: int,
    stride: int,
    element_budget: int = 64_000_000,
):
    """Numerators (nA, nY·nX) via batched window accumulation: each beam's
    response contribution over the whole candidate lattice is a CONTIGUOUS
    (span_y, span_x) window of the correlation grid at the beam's rotated
    cell offset, so per angle the search is one vmapped dynamic_slice over
    beams + an int32 reduction — row-contiguous loads instead of
    (angles × candidates × beams) random gathers. (A conv formulation —
    scatter rotated beams into a one-hot kernel, correlate with the grid —
    was also tried and lost: a single-input-channel 481² conv kernel
    tiles poorly.)

    Candidate cells form an exact integer-stride lattice because the search
    offsets are integer multiples of the grid resolution (CorrelateScan's
    xPoses/yPoses, Mapper.cpp:330).

    cand0_xy: (2,) int32 grid cell of the first (lowest x, lowest y)
    candidate. int32-exact like the gather path.
    """
    span_x = (n_x - 1) * stride + 1
    span_y = (n_y - 1) * stride + 1
    n = pts_cells.shape[0]

    def slice_one(oyi, oxi, v):
        w = jax.lax.dynamic_slice(
            grid, (cand0_xy[1] + oyi, cand0_xy[0] + oxi), (span_y, span_x)
        )
        return jnp.where(v, w[::stride, ::stride], 0)  # (nY, nX)

    def per_angle(angle):
        c, s = jnp.cos(angle), jnp.sin(angle)
        ox = kround_i(c * pts_cells[:, 0] - s * pts_cells[:, 1])
        oy = kround_i(s * pts_cells[:, 0] + c * pts_cells[:, 1])
        # beams vectorized: one (n, span_y, span_x) batched-window load per
        # angle (row-contiguous, unlike per-element random gathers or a
        # sequential per-beam scan), then an int32 reduction
        W = jax.vmap(slice_one)(oy, ox, beam_valid)
        return jnp.sum(W, axis=0).reshape(-1)  # (nY·nX,) y-major

    # angles in memory-bounded batches: peak extra memory per mapped step is
    # batch · n · span_y · span_x int32
    bs = max(
        1,
        min(angles.shape[0], element_budget // max(n * span_y * span_x, 1)),
    )
    return jax.lax.map(per_angle, angles, batch_size=bs)


def correlate_scan(
    grid: jax.Array,
    params: CorrelativeParams,
    grid_center_xy: jax.Array,
    search_center: jax.Array,
    scan_pts_laser: jax.Array,
    beam_valid: jax.Array,
    x_offsets: np.ndarray,
    y_offsets: np.ndarray,
    n_angles: int,
    angle_offset: float,
    angle_res: float,
    do_penalize: bool,
    params_pen: CorrelativeParams | None = None,
    element_budget: int | None = None,
) -> CorrelateResult:
    """One CorrelateScan pass (Mapper.cpp:309-523).

    search_center: (3,) pose; candidate poses are center + (dx, dy) over the
    static offset grids and headings center.θ − angle_offset + i·angle_res.
    scan_pts_laser: (N, 2) beam endpoints in the LASER frame (the reference's
    inverse-transformed localPoints, Karto.h:6430-6435) — ALL beams; NaN/inf
    beams carry beam_valid=False (INVALID_SCAN, Karto.h:6477-6482).
    """
    p = params
    g = p.grid_size
    w8 = p.row_stride
    grid_flat = grid.reshape(-1)
    dtype = scan_pts_laser.dtype

    nX, nY = len(x_offsets), len(y_offsets)
    xo = jnp.asarray(x_offsets, dtype)
    yo = jnp.asarray(y_offsets, dtype)

    angles = search_center[2] - angle_offset + angle_res * jnp.arange(
        n_angles, dtype=dtype
    )
    pts_cells = scan_pts_laser / p.resolution

    stride = _lattice_stride(x_offsets, y_offsets, p.resolution)
    if stride is not None:
        # offsets are integer multiples of the resolution (CorrelateScan's
        # xPoses/yPoses, Mapper.cpp:330), so the candidate lattice has an
        # exact integer stride and the windowed response paths apply; only
        # the first candidate's cell needs the rounding below
        rel0 = (search_center[:2] + jnp.stack([xo[0], yo[0]])
                - grid_center_xy) / p.resolution
        cand0 = kround_i(rel0) + p.center_cell  # [x, y]
        nums = _responses_sliced(
            grid, pts_cells, beam_valid, angles, cand0, nX, nY, stride,
            element_budget=element_budget or 64_000_000,
        )  # (nA, nY*nX) int32
    else:
        # irregular offsets: per-candidate rounding + random gathers
        cand_xy = jnp.stack(
            jnp.meshgrid(yo, xo, indexing="ij"), axis=-1
        )  # (nY, nX, 2) [y, x]
        cand_world = search_center[:2] + cand_xy[..., ::-1]
        rel = (cand_world - grid_center_xy) / p.resolution
        cix = kround_i(rel[..., 0]) + p.center_cell
        ciy = kround_i(rel[..., 1]) + p.center_cell
        cand_flat = (ciy * w8 + cix).reshape(-1)  # (nY*nX,)
        nums = _responses_for_angles(
            grid_flat, g, w8, pts_cells, beam_valid, angles, cand_flat,
            element_budget=min(24_000_000, element_budget or 24_000_000),
        )  # (nA, nY*nX) int32
    # normalize by the TOTAL reading count — the reference's nPoints is the
    # lookup-array size = ALL beams incl. NaN ones (GetResponse,
    # Mapper.cpp:852-853), not the valid count
    n_beams = scan_pts_laser.shape[0]
    resp = nums.astype(dtype) / (GRID_OCCUPIED * n_beams)  # (nA, nCand)
    resp = resp.reshape(n_angles, nY, nX)

    if do_penalize:
        sq_dist = xo[None, :] ** 2 + yo[:, None] ** 2  # (nY, nX)
        dist_pen = 1.0 - DISTANCE_PENALTY_GAIN * sq_dist / p.distance_variance_penalty
        dist_pen = jnp.maximum(dist_pen, p.minimum_distance_penalty)
        dth = angles - search_center[2]
        ang_pen = 1.0 - ANGLE_PENALTY_GAIN * dth**2 / p.angle_variance_penalty
        ang_pen = jnp.maximum(ang_pen, p.minimum_angle_penalty)
        pen = dist_pen[None, :, :] * ang_pen[:, None, None]
        resp = jnp.where(resp > 0.0, resp * pen, resp)  # only nonzero resp
        # (Mapper.cpp:399-414 penalizes only when response != 0)

    best = jnp.max(resp)
    ties = resp >= best - KT_TOLERANCE  # DoubleEqual tie set (:455-487)
    tie_f = ties.astype(dtype)
    cnt = jnp.sum(tie_f)
    ax = jnp.sum(tie_f * (search_center[0] + xo)[None, None, :]) / cnt
    ay = jnp.sum(tie_f * (search_center[1] + yo)[None, :, None]) / cnt
    acos = jnp.sum(tie_f * jnp.cos(angles)[:, None, None]) / cnt
    asin = jnp.sum(tie_f * jnp.sin(angles)[:, None, None]) / cnt
    best_pose = jnp.stack([ax, ay, jnp.arctan2(asin, acos)])

    search_probs = jnp.max(resp, axis=0)  # SearchSpaceProbs (per-cell max)
    # angle responses at the best (tie-averaged) position's cell
    brel = (best_pose[:2] - grid_center_xy) / p.resolution
    bix = kround_i(brel[0]) + p.center_cell
    biy = kround_i(brel[1]) + p.center_cell
    bflat = biy * w8 + bix

    def ang_resp(angle):
        c, s = jnp.cos(angle), jnp.sin(angle)
        rx = c * pts_cells[:, 0] - s * pts_cells[:, 1]
        ry = s * pts_cells[:, 0] + c * pts_cells[:, 1]
        idx = bflat + kround_i(ry) * w8 + kround_i(rx)
        ok = beam_valid & (idx >= 0) & (idx < g * w8)
        return jnp.sum(
            jnp.where(ok, grid_flat[jnp.clip(idx, 0, g * w8 - 1)], 0)
        ).astype(dtype) / (GRID_OCCUPIED * n_beams)

    angle_responses = jax.lax.map(ang_resp, angles)
    return CorrelateResult(best_pose, best, search_probs, angle_responses)


def positional_covariance(
    params: CorrelativeParams,
    best_pose: jax.Array,
    best_response: jax.Array,
    search_center: jax.Array,
    x_offsets: np.ndarray,
    y_offsets: np.ndarray,
    angle_res: float,
    search_probs: jax.Array,
) -> jax.Array:
    """ComputePositionalCovariance (Mapper.cpp:535-633)."""
    dtype = best_pose.dtype
    xo = jnp.asarray(x_offsets, dtype)
    yo = jnp.asarray(y_offsets, dtype)
    dx = best_pose[0] - search_center[0]
    dy = best_pose[1] - search_center[1]
    keep = search_probs >= best_response - 0.1
    w = jnp.where(keep, search_probs, 0.0)
    norm = jnp.sum(w)
    X = xo[None, :] - dx
    Y = yo[:, None] - dy
    vxx = jnp.sum(X**2 * w) / jnp.maximum(norm, KT_TOLERANCE)
    vxy = jnp.sum(X * Y * w) / jnp.maximum(norm, KT_TOLERANCE)
    vyy = jnp.sum(Y**2 * w) / jnp.maximum(norm, KT_TOLERANCE)
    res_step = x_offsets[1] - x_offsets[0] if len(x_offsets) > 1 else params.resolution
    min_v = 0.1 * res_step**2
    vxx = jnp.maximum(vxx, min_v)
    vyy = jnp.maximum(vyy, min_v)
    mult = 1.0 / jnp.maximum(best_response, KT_TOLERANCE)
    vth = 4.0 * angle_res**2
    # zero-variance fallback (:622-633): DoubleEqual(cov_ii, 0) → MAX
    cxx = jnp.where(jnp.abs(vxx * mult) <= KT_TOLERANCE, MAX_VARIANCE,
                    vxx * mult)
    cyy = jnp.where(jnp.abs(vyy * mult) <= KT_TOLERANCE, MAX_VARIANCE,
                    vyy * mult)
    cov = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], dtype
    )
    cov = cov.at[0, 0].set(cxx)
    cov = cov.at[0, 1].set(vxy * mult)
    cov = cov.at[1, 0].set(vxy * mult)
    cov = cov.at[1, 1].set(cyy)
    cov = cov.at[2, 2].set(vth)
    # norm ≤ tol: reference leaves the identity covariance untouched
    # (:597-618 only runs when norm > tol) — unreachable when bestResponse ≥
    # tol (the best cell always passes the −0.1 gate) but mirrored anyway
    eye = jnp.eye(3, dtype=dtype)
    cov = jnp.where(norm > KT_TOLERANCE, cov, eye)
    # bestResponse < tol → MAX_VARIANCE early-out (:545-556)
    bad = best_response < KT_TOLERANCE
    big = jnp.array(
        [
            [MAX_VARIANCE, 0.0, 0.0],
            [0.0, MAX_VARIANCE, 0.0],
            [0.0, 0.0, 4.0 * angle_res**2],
        ],
        dtype,
    )
    return jnp.where(bad, big, cov)


def angular_covariance(
    best_pose: jax.Array,
    best_response: jax.Array,
    search_center: jax.Array,
    angle_offset: float,
    angle_res: float,
    angle_responses: jax.Array,
    cov: jax.Array,
) -> jax.Array:
    """ComputeAngularCovariance (Mapper.cpp:641-693); overwrites cov[2,2]."""
    dtype = best_pose.dtype
    n = angle_responses.shape[0]
    angles = search_center[2] - angle_offset + angle_res * jnp.arange(
        n, dtype=dtype
    )
    best_angle = geo.normalize_angle(best_pose[2] - search_center[2]) + search_center[2]
    keep = angle_responses >= best_response - 0.1
    w = jnp.where(keep, angle_responses, 0.0)
    norm = jnp.sum(w)
    acc = jnp.sum((angles - best_angle) ** 2 * w)
    # the res² floor applies BEFORE the norm division (Mapper.cpp:679-686):
    # acc < tol → res²/norm, not res²
    acc = jnp.where(acc < KT_TOLERANCE, angle_res**2, acc)
    vth = jnp.where(
        norm > KT_TOLERANCE,
        acc / jnp.maximum(norm, KT_TOLERANCE),
        1000.0 * angle_res**2,
    )
    return cov.at[2, 2].set(vth)


def find_valid_points(
    pts: jax.Array, valid: jax.Array, viewpoint: jax.Array
) -> jax.Array:
    """FindValidPoints (Mapper.cpp:765-813): the reference walks the scan
    keeping a trailing iterator; when the walk reaches an anchor advance
    (≥10 cm from the previous anchor) the run of points SINCE the previous
    anchor — anchor-exclusive, `[trailing, iter)` — is kept iff the
    determinant test at the new anchor says the surface faces the viewpoint
    (ss ≥ 0). The run after the LAST anchor is never pushed. Two fixed-shape
    passes: a forward scan for anchors + per-run verdicts, a backward scan
    assigning each point the verdict of the first anchor strictly after it
    (False if none).

    ``pts`` must be the RAW unfiltered endpoints (Karto.h:5378-5404): the
    reference walk has NO validity gating — ±inf points (inf ranges) ARE
    anchor candidates (delta² = inf > 0.01) with NaN determinants falling
    into the keep branch, and only NaN points are skipped when picking the
    first point (Mapper.cpp:776-781). IEEE semantics reproduce this exactly;
    ``valid`` only masks the returned keep flags (the reference drops those
    points later at the grid-bounds check, Mapper.cpp:723-730)."""
    min_sq = 0.1**2

    def fwd(anchor, inp):
        p = inp
        # no valid-gating: NaN dist compares False, inf compares True —
        # exactly the C++ behavior on unfiltered points
        moved = jnp.sum((anchor - p) ** 2) > min_sq
        # reference coefficients (Mapper.cpp:792-800)
        a = viewpoint[1] - anchor[1]
        b = anchor[0] - viewpoint[0]
        cc = anchor[1] * viewpoint[0] - anchor[0] * viewpoint[1]
        ss = p[0] * a + p[1] * b + cc
        new_anchor = jnp.where(moved, p, anchor)
        # NaN ss < 0 is False in C++ → the run is PUSHED; ~(ss < 0) matches
        return new_anchor, (moved, ~(ss < 0.0))

    not_nan = ~jnp.isnan(pts).any(axis=-1)
    first_idx = jnp.argmax(not_nan)
    anchor0 = pts[first_idx]
    # unroll: the loop-carried state is tiny (one anchor point) and each
    # device loop trip has a fixed launch latency — 2×N sequential trips
    # would dominate a whole correlative match
    _, (moved, ok) = jax.lax.scan(fwd, anchor0, pts, unroll=32)

    def bwd(pending, inp):
        m, o = inp
        # emit the verdict of the first anchor AFTER this point, then fold
        # in this point's own anchor status for earlier points
        keep_here = pending
        verdict = jnp.where(m, o, pending)
        return verdict, keep_here

    _, keep = jax.lax.scan(
        bwd, jnp.array(False), (moved, ok), reverse=True, unroll=32
    )
    return valid & keep


class MatchResult(NamedTuple):
    pose: jax.Array  # (3,) best pose (world)
    response: jax.Array  # scalar in [0, 1]
    covariance: jax.Array  # (3, 3)


class CorrelativeMatcher:
    """MatchScan orchestration (Mapper.cpp:184-291): coarse correlate →
    optional response-expansion (±20°,±40°,±60° widening, :242-272) → fine
    correlate (doRefineMatch) → covariances.

    The expansion retries are host control flow over separately-jitted
    fixed-shape correlate programs (three extra angle widths, compile-cached)
    — the rare-path analogue of the reference's loop.
    """

    def __init__(
        self,
        params: CorrelativeParams,
        use_response_expansion=True,
    ):
        self.p = params
        self.use_response_expansion = use_response_expansion
        p = params
        res = p.resolution
        # coarse: half the cells (2×res step) over the search window
        # (MatchScan, Mapper.cpp:228-236)
        half = 0.5 * (p.n_search - 1) * res
        n_coarse = int(round(half * 2.0 / (2.0 * res))) + 1
        self.coarse_x = np.asarray(
            [-half + i * 2.0 * res for i in range(n_coarse)], np.float32
        )
        self.coarse_y = self.coarse_x.copy()
        # fine: ±coarse_step/2 at res step → 3 offsets per axis (:275-281)
        self.fine_x = np.asarray([-res, 0.0, res], np.float32)
        self.fine_y = self.fine_x.copy()
        self.n_angles_coarse = (
            int(round(p.angle_offset * 2.0 / p.angle_res)) + 1
        )
        # fine pass: angle window ±coarse_res/2 at fine_angle_offset step
        self.fine_angle_offset = 0.5 * p.angle_res
        self.n_angles_fine = (
            int(round(self.fine_angle_offset * 2.0 / p.fine_angle_offset)) + 1
        )

        self._full_cache = {}

    def _match_fn(
        self,
        angle_offset: float,
        do_penalize: bool,
        do_fine: bool,
        element_budget: int | None = None,
    ):
        """The (unjitted) fused match program: grid build → coarse correlate
        → positional covariance → fine correlate → angular covariance."""
        p = self.p
        n_ang = int(round(angle_offset * 2.0 / p.angle_res)) + 1

        def f(base_pts, base_valid, pts, bvalid, scan_pose):
            grid_center = scan_pose[:2]
            grid = build_correlation_grid(
                p, grid_center, base_pts, base_valid
            )
            coarse = correlate_scan(
                grid, p, grid_center, scan_pose, pts, bvalid,
                self.coarse_x, self.coarse_y, n_ang,
                angle_offset, p.angle_res, do_penalize=do_penalize,
                element_budget=element_budget,
            )
            cov = positional_covariance(
                p, coarse.best_pose, coarse.best_response, scan_pose,
                self.coarse_x, self.coarse_y, p.angle_res,
                coarse.search_probs,
            )
            pose = coarse.best_pose
            response = coarse.best_response
            if do_fine:
                fine = correlate_scan(
                    grid, p, grid_center, pose, pts, bvalid,
                    self.fine_x, self.fine_y, self.n_angles_fine,
                    self.fine_angle_offset, p.fine_angle_offset,
                    do_penalize=True,
                    element_budget=element_budget,
                )
                cov = angular_covariance(
                    fine.best_pose, fine.best_response, pose,
                    self.fine_angle_offset, p.fine_angle_offset,
                    fine.angle_responses, cov,
                )
                pose = fine.best_pose
                response = fine.best_response
            return MatchResult(
                pose, jnp.minimum(response, 1.0), cov
            )

        return f

    def _full_packed(self, angle_offset: float, do_penalize: bool,
                     do_fine: bool):
        """One fused device program per (angle window, penalty, fine)
        combo, with the result PACKED into one (13,) vector
        [pose, response, cov.ravel()]: one device→host fetch per match
        instead of three."""
        key = ("packed", angle_offset, do_penalize, do_fine)
        if key not in self._full_cache:
            f = self._match_fn(angle_offset, do_penalize, do_fine)

            def packed(*a):
                r = f(*a)
                return jnp.concatenate(
                    [r.pose, r.response[None], r.covariance.ravel()]
                )

            self._full_cache[key] = jax.jit(packed)
        return self._full_cache[key]

    def _full_chains(
        self, n_chains: int, n_scans: int, n_beams: int, angle_offset: float,
        do_penalize: bool, do_fine: bool,
    ):
        """Batched variant: ONE device program matching the same scan against
        ``n_chains`` independent base-scan sets (the near-chain / loop-chain
        fan-out of MapperGraph::AddEdges and TryCloseLoop, Mapper.cpp:902-1051
        — the reference runs these MatchScan calls sequentially). The
        base-scan world transform and FindValidPoints view filter are fused
        in, so a whole chain group costs one dispatch + one host sync.

        Transfer protocol: every host↔device array is a separate transfer,
        so the program takes ONE packed f32 buffer
        (poses | base pts | base valid | scan pts | beam valid | pose) and
        returns ONE (C, 13) result tensor (pose(3) | response(1) | cov(9))."""
        C, S, N = n_chains, n_scans, n_beams
        key = ("chains", C, S, N, angle_offset, do_penalize, do_fine)
        if key not in self._full_cache:
            # the angle-group memory budget is shared across vmapped lanes
            budget = max(2_000_000, 64_000_000 // n_chains)
            core = self._match_fn(
                angle_offset, do_penalize, do_fine, element_budget=budget
            )

            def one(base_poses, base_pts_l, base_valid, pts, bvalid, pose):
                wp = geo.apply(base_poses[:, None, :], base_pts_l)
                keep = jax.vmap(find_valid_points, in_axes=(0, 0, None))(
                    wp, base_valid, pose[:2]
                )
                r = core(
                    wp.reshape(-1, 2), keep.reshape(-1), pts, bvalid, pose
                )
                return jnp.concatenate(
                    [r.pose, r.response[None], r.covariance.reshape(9)]
                )

            def packed(buf):
                o = 0
                poses = buf[o : o + C * S * 3].reshape(C, S, 3)
                o += C * S * 3
                bpts = buf[o : o + C * S * N * 2].reshape(C, S, N, 2)
                o += C * S * N * 2
                bvalid = buf[o : o + C * S * N].reshape(C, S, N) > 0.5
                o += C * S * N
                spts = buf[o : o + N * 2].reshape(N, 2)
                o += N * 2
                svalid = buf[o : o + N] > 0.5
                o += N
                spose = buf[o : o + 3]
                # unrolled over lanes (C <= 4)
                return jnp.stack(
                    [
                        one(poses[k], bpts[k], bvalid[k], spts, svalid,
                            spose)
                        for k in range(C)
                    ]
                )

            self._full_cache[key] = jax.jit(packed)
        return self._full_cache[key]

    def _full_chains_store(
        self, n_chains: int, n_scans: int, n_beams: int,
        cap: tuple,  # (store rows, store beam count)
        angle_offset: float, do_penalize: bool, do_fine: bool,
    ):
        """Index-addressed variant of _full_chains: base-scan points live in
        a DEVICE-RESIDENT store (cap, N, 2)+(cap, N) and chains arrive as
        row indices, so the per-call host→device transfer is KBs instead of
        the chains' full point data (a 4-chain × 512-scan loop group is
        ~4.4 MB; scan points are immutable — only poses change — so they
        upload exactly once, when the scan is accepted)."""
        C, S, N = n_chains, n_scans, n_beams
        # N is the QUERY scan's beam count; the store's own (cap, N_store)
        # shape keys the executable via cap + store_beams
        key = ("chains_store", C, S, N, cap, angle_offset, do_penalize,
               do_fine)
        if key not in self._full_cache:
            budget = max(2_000_000, 64_000_000 // n_chains)
            core = self._match_fn(
                angle_offset, do_penalize, do_fine, element_budget=budget
            )

            def one(store_pts, store_valid, base_poses, idx, member,
                    pts, bvalid, pose):
                bp = store_pts[idx]  # (S, N, 2) gather from the store
                bv = store_valid[idx] & member[:, None]
                wp = geo.apply(base_poses[:, None, :], bp)
                keep = jax.vmap(find_valid_points, in_axes=(0, 0, None))(
                    wp, bv, pose[:2]
                )
                r = core(
                    wp.reshape(-1, 2), keep.reshape(-1), pts, bvalid, pose
                )
                return jnp.concatenate(
                    [r.pose, r.response[None], r.covariance.reshape(9)]
                )

            def packed(store_pts, store_valid, buf):
                o = 0
                poses = buf[o : o + C * S * 3].reshape(C, S, 3)
                o += C * S * 3
                idxf = buf[o : o + C * S].reshape(C, S)
                o += C * S
                spts = buf[o : o + N * 2].reshape(N, 2)
                o += N * 2
                svalid = buf[o : o + N] > 0.5
                o += N
                spose = buf[o : o + 3]
                member = idxf >= -0.5  # padded members carry idx −1
                idx = jnp.clip(idxf.astype(jnp.int32), 0, cap[0] - 1)
                return jnp.stack(
                    [
                        one(store_pts, store_valid, poses[k], idx[k],
                            member[k], spts, svalid, spose)
                        for k in range(C)
                    ]
                )

            self._full_cache[key] = jax.jit(packed)
        return self._full_cache[key]

    def _full_anchor_store(
        self, n_lanes: int, n_scans: int,
        cap: tuple,  # (store rows, store beam count)
        do_penalize: bool, do_fine: bool,
    ):
        """Multi-QUERY variant of _full_chains_store: each lane matches its
        OWN query scan (a store row) against its own base-scan set. Built
        for the offline anchor sweep (models/offline.py): hundreds of
        independent scan-to-submap re-anchoring matches batched C lanes per
        dispatch, with only indices + poses crossing the link.

        buf layout per call: [base_poses (C,S,3) | base idx (C,S) |
        query idx (C,) | query poses (C,3)] — flat f32."""
        C, S = n_lanes, n_scans
        N = cap[1]  # query beams come from the same store
        key = ("anchor_store", C, S, cap, do_penalize, do_fine)
        if key not in self._full_cache:
            budget = max(2_000_000, 64_000_000 // n_lanes)
            core = self._match_fn(
                self.p.angle_offset, do_penalize, do_fine,
                element_budget=budget,
            )

            def one(store_pts, store_valid, base_poses, idx, member,
                    qi, pose):
                bp = store_pts[idx]  # (S, N, 2)
                bv = store_valid[idx] & member[:, None]
                wp = geo.apply(base_poses[:, None, :], bp)
                keep = jax.vmap(find_valid_points, in_axes=(0, 0, None))(
                    wp, bv, pose[:2]
                )
                r = core(
                    wp.reshape(-1, 2), keep.reshape(-1),
                    store_pts[qi], store_valid[qi], pose,
                )
                return jnp.concatenate(
                    [r.pose, r.response[None], r.covariance.reshape(9)]
                )

            def packed(store_pts, store_valid, buf):
                o = 0
                poses = buf[o : o + C * S * 3].reshape(C, S, 3)
                o += C * S * 3
                idxf = buf[o : o + C * S].reshape(C, S)
                o += C * S
                qif = buf[o : o + C]
                o += C
                qposes = buf[o : o + C * 3].reshape(C, 3)
                member = idxf >= -0.5  # padded members carry idx −1
                idx = jnp.clip(idxf.astype(jnp.int32), 0, cap[0] - 1)
                qi = jnp.clip(qif.astype(jnp.int32), 0, cap[0] - 1)
                # unrolled over lanes
                return jnp.stack(
                    [
                        one(store_pts, store_valid, poses[k], idx[k],
                            member[k], qi[k], qposes[k])
                        for k in range(C)
                    ]
                )

            self._full_cache[key] = jax.jit(packed)
        return self._full_cache[key]

    def match_anchors_store_async(
        self,
        store_pts,  # (cap, N, 2) device-resident laser points
        store_valid,  # (cap, N)
        chain_idx: np.ndarray,  # (C, S) store rows; −1 = padded member
        base_poses: np.ndarray,  # (C, S, 3) current sensor poses
        query_idx: np.ndarray,  # (C,) store row of each lane's query scan
        query_poses: np.ndarray,  # (C, 3) search-center pose per lane
        do_penalize: bool = True,
        do_fine: bool = True,
    ):
        """Dispatch one C-lane anchor group; returns the raw (C, 13) device
        array (pose | response | cov). Callers queue many groups and fetch
        once — each synchronous fetch waits for the device."""
        C, S = (int(d) for d in np.shape(chain_idx))
        cap = (int(store_pts.shape[0]), int(store_pts.shape[1]))
        buf = np.concatenate(
            [
                np.asarray(base_poses, np.float32).ravel(),
                np.asarray(chain_idx, np.float32).ravel(),
                np.asarray(query_idx, np.float32).ravel(),
                np.asarray(query_poses, np.float32).ravel(),
            ]
        )
        return self._full_anchor_store(C, S, cap, do_penalize, do_fine)(
            store_pts, store_valid, buf
        )

    def match_chains_store(
        self,
        store_pts: jax.Array,  # (cap, N, 2) device-resident laser points
        store_valid: jax.Array,  # (cap, N)
        chain_idx: np.ndarray,  # (C, S) store rows; −1 = padded member
        base_poses: np.ndarray,  # (C, S, 3) corrected sensor poses
        scan_pts_laser: np.ndarray,
        beam_valid: np.ndarray,
        scan_pose: np.ndarray,
        do_penalize: bool = True,
        do_fine: bool = True,
        lane_valid: np.ndarray | None = None,
    ) -> MatchResult:
        """match_chains against the device-resident store: identical
        semantics, only chain INDICES cross the link."""
        return self.match_chains_store_async(
            store_pts, store_valid, chain_idx, base_poses, scan_pts_laser,
            beam_valid, scan_pose, do_penalize, do_fine, lane_valid,
        ).resolve()

    def match_chains_store_async(
        self,
        store_pts,
        store_valid,
        chain_idx,
        base_poses,
        scan_pts_laser,
        beam_valid,
        scan_pose,
        do_penalize: bool = True,
        do_fine: bool = True,
        lane_valid: np.ndarray | None = None,
    ) -> "PendingChainMatch":
        """Dispatch form of match_chains_store: enqueues the device program
        and returns a handle; `.resolve()` fetches + post-processes. Lets a
        caller with several chain groups overlap their device executions
        and pay ONE host sync round instead of one per group."""
        p = self.p
        C, S = (int(d) for d in np.shape(chain_idx))
        N = int(scan_pts_laser.shape[-2])
        # cap + store beam count key the executable alongside the query N
        cap = (int(store_pts.shape[0]), int(store_pts.shape[1]))

        def pack(bp, ci):
            return np.concatenate(
                [
                    np.asarray(bp, np.float32).ravel(),
                    np.asarray(ci, np.float32).ravel(),
                    np.asarray(scan_pts_laser, np.float32).ravel(),
                    np.asarray(beam_valid, np.float32).ravel(),
                    np.asarray(scan_pose, np.float32).ravel(),
                ]
            )

        out_dev = self._full_chains_store(
            C, S, N, cap, p.angle_offset, do_penalize, do_fine
        )(store_pts, store_valid, pack(base_poses, chain_idx))
        return PendingChainMatch(
            self, out_dev, pack, store_pts, store_valid, base_poses,
            chain_idx, S, N, cap, do_penalize, do_fine, lane_valid,
        )

    @staticmethod
    def _pack_chain_buf(
        base_poses, base_pts_laser, base_valid, scan_pts_laser, beam_valid,
        scan_pose,
    ) -> np.ndarray:
        return np.concatenate(
            [
                np.asarray(base_poses, np.float32).ravel(),
                np.asarray(base_pts_laser, np.float32).ravel(),
                np.asarray(base_valid, np.float32).ravel(),
                np.asarray(scan_pts_laser, np.float32).ravel(),
                np.asarray(beam_valid, np.float32).ravel(),
                np.asarray(scan_pose, np.float32).ravel(),
            ]
        )

    def match(
        self,
        base_pts: jax.Array,
        base_valid: jax.Array,
        scan_pts_laser: jax.Array,
        beam_valid: jax.Array,
        scan_pose: jax.Array,
        do_penalize: bool = True,
        do_fine: bool = True,
    ) -> MatchResult:
        p = self.p

        def run(ao):
            raw = np.asarray(  # ONE device→host fetch for the whole result
                self._full_packed(ao, do_penalize, do_fine)(
                    base_pts, base_valid, scan_pts_laser, beam_valid,
                    scan_pose,
                )
            )
            return MatchResult(
                raw[0:3], raw[3], raw[4:13].reshape(3, 3)
            )

        res = run(p.angle_offset)
        if self.use_response_expansion and float(res.response) < KT_TOLERANCE:
            angle_offset = p.angle_offset
            for i in range(3):  # widen by 20° up to 3 times (:242-272)
                angle_offset += math.radians(20.0)
                res = run(round(angle_offset, 6))
                if float(res.response) >= KT_TOLERANCE:
                    break
        return res

    def match_chains(
        self,
        base_poses: np.ndarray,
        base_pts_laser: np.ndarray,
        base_valid: np.ndarray,
        scan_pts_laser: np.ndarray,
        beam_valid: np.ndarray,
        scan_pose: np.ndarray,
        do_penalize: bool = True,
        do_fine: bool = True,
        lane_valid: np.ndarray | None = None,
    ) -> MatchResult:
        """Match one scan against C independent base-scan sets in ONE device
        program + ONE host sync (vs the reference's C sequential MatchScan
        calls in AddEdges/TryCloseLoop).

        base_poses: (C, S, 3) corrected sensor poses of each chain's scans,
        base_pts_laser: (C, S, N, 2) their laser-frame beam endpoints,
        base_valid: (C, S, N); padded lanes/scans marked invalid.
        lane_valid: (C,) — padded lanes excluded from response expansion.
        Returns a MatchResult of host numpy arrays with leading C axis.
        """
        p = self.p
        C, S, N = (int(d) for d in np.shape(base_valid))
        buf = self._pack_chain_buf(
            base_poses, base_pts_laser, base_valid, scan_pts_laser,
            beam_valid, scan_pose,
        )
        out = np.asarray(
            self._full_chains(C, S, N, p.angle_offset, do_penalize, do_fine)(
                buf
            )
        )  # (C, 13): ONE device→host fetch
        poses = out[:, :3].astype(np.float64)
        resps = out[:, 3].copy()
        covs = out[:, 4:].reshape(C, 3, 3).astype(np.float64)
        if self.use_response_expansion:
            lanes = np.ones(C, bool) if lane_valid is None else np.asarray(
                lane_valid, bool
            )
            for k in np.nonzero(lanes & (resps < KT_TOLERANCE))[0]:
                buf1 = self._pack_chain_buf(
                    base_poses[k : k + 1], base_pts_laser[k : k + 1],
                    base_valid[k : k + 1], scan_pts_laser, beam_valid,
                    scan_pose,
                )
                angle_offset = p.angle_offset
                for _ in range(3):  # rare path: widen per failing lane
                    angle_offset += math.radians(20.0)
                    o1 = np.asarray(
                        self._full_chains(
                            1, S, N, round(angle_offset, 6), do_penalize,
                            do_fine,
                        )(buf1)
                    )[0]
                    if o1[3] >= KT_TOLERANCE:
                        break
                poses[k] = o1[:3]
                resps[k] = o1[3]
                covs[k] = o1[4:].reshape(3, 3)
        return MatchResult(poses, resps, covs)


class PendingChainMatch:
    """In-flight chain-group match (device arrays not yet fetched)."""

    def __init__(self, m, out_dev, pack, store_pts, store_valid, base_poses,
                 chain_idx, S, N, cap, do_penalize, do_fine, lane_valid):
        self._m = m
        self._out = out_dev
        self._pack = pack
        self._args = (store_pts, store_valid, base_poses, chain_idx)
        self._shape = (S, N, cap)
        self._opts = (do_penalize, do_fine)
        self._lanes = lane_valid

    def resolve(self) -> MatchResult:
        m = self._m
        store_pts, store_valid, base_poses, chain_idx = self._args
        S, N, cap = self._shape
        do_penalize, do_fine = self._opts
        out = np.asarray(self._out)
        C = out.shape[0]
        poses = out[:, :3].astype(np.float64)
        resps = out[:, 3].copy()
        covs = out[:, 4:].reshape(C, 3, 3).astype(np.float64)
        if m.use_response_expansion:
            lanes = (
                np.ones(C, bool) if self._lanes is None
                else np.asarray(self._lanes, bool)
            )
            fails = list(np.nonzero(lanes & (resps < KT_TOLERANCE))[0])
            # per widening width, retries for ALL still-failing lanes
            # dispatch CONCURRENTLY and resolve in one fetch pass —
            # identical per-lane results to the reference's sequential
            # widening, but the host pays ≤3 sync rounds TOTAL instead
            # of up to 3 per failing lane, and (unlike dispatching every
            # width up front — the 40°/60° programs are big) no device
            # work the sequential loop wouldn't do
            angle_offset = m.p.angle_offset
            for _ in range(3):
                if not fails:
                    break
                angle_offset += math.radians(20.0)
                pend = []
                for k in fails:
                    buf1 = self._pack(
                        base_poses[k : k + 1], chain_idx[k : k + 1]
                    )
                    pend.append((
                        k,
                        m._full_chains_store(
                            1, S, N, cap, round(angle_offset, 6),
                            do_penalize, do_fine,
                        )(store_pts, store_valid, buf1),
                    ))
                still = []
                for k, dev in pend:
                    o1 = np.asarray(dev)[0]
                    poses[k] = o1[:3]
                    resps[k] = o1[3]
                    covs[k] = o1[4:].reshape(3, 3)
                    if o1[3] < KT_TOLERANCE:
                        still.append(k)
                fails = still
        return MatchResult(poses, resps, covs)
