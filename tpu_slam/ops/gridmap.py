"""Occupancy-grid substrate: ray rasterization + three cell models.

Replacement for the reference's three grid stacks:
  * Hector log-odds grids + per-scan dedup update
    (`lesson4/include/lesson4/hector_mapping/map/OccGridMapBase.h:118-330`,
    `GridMapLogOdds.h:37-161`)
  * GMapping hit/visit counters over Bresenham rays
    (`lesson4/src/gmapping/gmapping.cc:87-242`, `grid/gridlinetraversal.h`)
  * Karto pass/hit occupancy built from all scans
    (`open_karto/include/open_karto/Karto.h:5609-6039`)

Design (SURVEY §7 stage 4): instead of per-beam Bresenham loops, every ray is
sampled at a fixed sub-resolution step — a static (beams × samples) tensor of
cell indices — and cell updates become masked scatters. The reference's
"mark each cell at most once per scan, occupied beats free" update-index trick
(OccGridMapBase.h:302-330) becomes two boolean scatter-max masks combined as
``occ ∪ (free ∖ occ)``, which reproduces the semantics exactly and has no
write-order hazards (scatter-max of booleans is associative).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam.config import GridConfig, LogOddsConfig


def world_to_cell(cfg: GridConfig, xy: jax.Array) -> jax.Array:
    """World coords → fractional cell coords (x-col, y-row), (...,2)."""
    return (xy - jnp.asarray([cfg.origin_x, cfg.origin_y], xy.dtype)) / cfg.resolution


def cell_to_world(cfg: GridConfig, cxy: jax.Array) -> jax.Array:
    return cxy * cfg.resolution + jnp.asarray(
        [cfg.origin_x, cfg.origin_y], cxy.dtype
    )


# sentinel for "skip this cell": a large positive index that is out of bounds
# for any realistic grid, so `.at[].op(mode="drop")` discards it. (A -1
# sentinel would WRAP to the last cell under numpy-style negative indexing.)
OOB_INDEX = 1 << 30

# epsilon (in cells) so endpoints that land exactly on a cell border under
# f32 arithmetic (e.g. 94.0 computed as 93.99999) fall in the intended cell
_CELL_EPS = 1e-3


def cell_index(cfg: GridConfig, cxy: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Fractional cell coords → (flat row-major index, inbounds mask).

    Out-of-bounds returns OOB_INDEX, which `.at[].op(mode="drop")` discards —
    the vectorized form of the reference's pointOutOfMapBounds/IsUpTo guards.
    """
    ix = jnp.floor(cxy[..., 0] + _CELL_EPS).astype(jnp.int32)
    iy = jnp.floor(cxy[..., 1] + _CELL_EPS).astype(jnp.int32)
    inb = (ix >= 0) & (ix < cfg.size_x) & (iy >= 0) & (iy < cfg.size_y)
    flat = jnp.where(inb, iy * cfg.size_x + ix, OOB_INDEX)
    return flat, inb


def ray_cell_indices(
    cfg: GridConfig,
    origin_xy: jax.Array,
    endpoints: jax.Array,
    valid: jax.Array,
    step_frac: float = 0.7,
    max_range: float | None = None,
    stop_before_end: bool = True,
):
    """Sample every beam at ``step_frac × resolution`` along the ray.

    Returns (free_idx (N, S) int32 flat indices with OOB_INDEX = skip,
             end_idx (N,) endpoint indices with OOB_INDEX = skip).
    Free samples stop one resolution short of the endpoint so the endpoint
    cell is never marked free by its own beam (bresenham2D stops before the
    end cell, OccGridMapBase.h:270-313). Rays are truncated at ``max_range``.
    """
    d = endpoints - origin_xy[..., None, :]
    r = jnp.linalg.norm(d, axis=-1)
    r_safe = jnp.maximum(r, 1e-9)
    dirn = d / r_safe[..., None]
    if max_range is None:
        max_range = cfg.resolution * max(cfg.size_x, cfg.size_y)
    n_samples = int(max_range / (cfg.resolution * step_frac)) + 1

    t = (
        jnp.arange(n_samples, dtype=endpoints.dtype)
        * (cfg.resolution * step_frac)
    )
    # (..., N, S, 2) sample points
    pts = (
        origin_xy[..., None, None, :]
        + dirn[..., :, None, :] * t[None, :, None]
    )
    margin = cfg.resolution if stop_before_end else 0.0
    free_ok = (
        valid[..., None]
        & (t < (jnp.minimum(r, max_range) - margin)[..., None])
    )
    free_flat, free_inb = cell_index(cfg, world_to_cell(cfg, pts))
    free_idx = jnp.where(free_ok & free_inb, free_flat, OOB_INDEX)

    end_ok = valid & (r <= max_range)
    end_flat, end_inb = cell_index(cfg, world_to_cell(cfg, endpoints))
    end_idx = jnp.where(end_ok & end_inb, end_flat, OOB_INDEX)
    return free_idx, end_idx


def scan_masks(
    cfg: GridConfig,
    origin_xy: jax.Array,
    endpoints: jax.Array,
    valid: jax.Array,
    max_range: float | None = None,
):
    """Per-scan boolean (free, occ) cell masks with reference dedup semantics:
    each cell at most once per scan; endpoint (occupied) wins over free
    (OccGridMapBase.h:302-330 update-index stamps)."""
    ncells = cfg.size_x * cfg.size_y
    # free samples run all the way to the endpoint: the occupied-beats-free
    # combination below removes endpoint cells, matching Bresenham's
    # stop-before-end without losing the near-endpoint free band
    free_idx, end_idx = ray_cell_indices(
        cfg, origin_xy, endpoints, valid, max_range=max_range,
        stop_before_end=False,
    )
    free = jnp.zeros((ncells,), bool).at[free_idx.reshape(-1)].max(
        True, mode="drop"
    )
    occ = jnp.zeros((ncells,), bool).at[end_idx.reshape(-1)].max(
        True, mode="drop"
    )
    return free & ~occ, occ


def logodds_factors(cfg: LogOddsConfig, dtype=jnp.float32):
    """log(p/(1−p)) update increments (GridMapLogOdds.h:120-161)."""
    import math

    lo_free = math.log(cfg.p_free / (1.0 - cfg.p_free))
    lo_occ = math.log(cfg.p_occupied / (1.0 - cfg.p_occupied))
    return jnp.asarray(lo_free, dtype), jnp.asarray(lo_occ, dtype)


def logodds_update_scan(
    grid: jax.Array,
    cfg: GridConfig,
    locfg: LogOddsConfig,
    origin_xy: jax.Array,
    endpoints: jax.Array,
    valid: jax.Array,
    max_range: float | None = None,
) -> jax.Array:
    """One scan's log-odds update (updateByScan, OccGridMapBase.h:118-168).

    grid: flat (size_y*size_x,) log-odds array. Occupied cells are capped at
    ``log_odds_max`` (the `isOccupied` 50.0 cap, GridMapLogOdds.h:60).
    """
    free, occ = scan_masks(cfg, origin_xy, endpoints, valid, max_range)
    lo_free, lo_occ = logodds_factors(locfg, grid.dtype)
    upd = jnp.where(occ, lo_occ, jnp.where(free, lo_free, 0.0))
    return jnp.clip(grid + upd, locfg.log_odds_min, locfg.log_odds_max)


def occupancy_prob(grid: jax.Array) -> jax.Array:
    """Log-odds → probability: odds/(1+odds) (GridMapLogOdds.h:102-112)."""
    return jax.nn.sigmoid(grid)


def counts_update_scan(
    hits: jax.Array,
    visits: jax.Array,
    cfg: GridConfig,
    origin_xy: jax.Array,
    endpoints: jax.Array,
    valid: jax.Array,
    max_range: float | None = None,
    acc: jax.Array | None = None,
):
    """GMapping per-beam counters, **no** per-scan dedup: every beam's ray
    increments visits along the line and (visits, hits) at the endpoint
    (gmapping.cc:146-229, PointAccumulator grid/map.h:17-48).

    Count-valued scatter-adds: overlapping beams accumulate, exactly like the
    sequential Bresenham loops. If ``acc`` (cells, 2) is given, hit world
    positions are accumulated into it too and it is returned as a third
    output (PointAccumulator's acc field).
    """
    free_idx, end_idx = ray_cell_indices(
        cfg, origin_xy, endpoints, valid, max_range=max_range
    )
    # dedup per-beam (a ray can sample one cell twice at sub-res steps, the
    # Bresenham line visits it once): drop a sample whose cell equals the
    # previous sample's cell
    prev = jnp.concatenate(
        [jnp.full_like(free_idx[..., :1], OOB_INDEX + 1), free_idx[..., :-1]],
        axis=-1,
    )
    uniq = jnp.where(free_idx != prev, free_idx, OOB_INDEX)
    visits = visits.at[uniq.reshape(-1)].add(1, mode="drop")
    visits = visits.at[end_idx.reshape(-1)].add(1, mode="drop")
    hits = hits.at[end_idx.reshape(-1)].add(1, mode="drop")
    if acc is None:
        return hits, visits
    # PointAccumulator hit-position accumulation (grid/map.h:17-48:
    # `acc.x += hit.x; acc.y += hit.y` on every endpoint update): the same
    # endpoints that increment `hits` contribute their world coordinates
    acc = acc.at[end_idx.reshape(-1)].add(
        endpoints.reshape(-1, 2).astype(acc.dtype), mode="drop"
    )
    return hits, visits, acc


def counts_mean(acc: jax.Array, hits: jax.Array) -> jax.Array:
    """Per-cell mean hit position (PointAccumulator::mean, grid/map.h:17-48);
    cells with no hits → 0."""
    return acc / jnp.maximum(hits, 1)[..., None].astype(acc.dtype)


def counts_occupancy(
    hits: jax.Array, visits: jax.Array, threshold: float = 0.25
) -> jax.Array:
    """GMapping cell value: n/visits > threshold ⇒ occupied
    (gmapping.cc:146-158). Returns float fraction; never-visited cells → 0."""
    return hits / jnp.maximum(visits, 1)


def kround_i(x: jax.Array) -> jax.Array:
    """math::Round (half away from zero) → int32; the karto grid cell
    convention (WorldToGrid, Karto.h:4238-4252)."""
    return (jnp.sign(x) * jnp.floor(jnp.abs(x) + 0.5)).astype(jnp.int32)


def bresenham_cells(
    c0: jax.Array, c1: jax.Array, max_steps: int
) -> tuple[jax.Array, jax.Array]:
    """Karto's TraceLine cell walk (Karto.h:4680-4745), closed form.

    c0, c1: (..., 2) int32 endpoint cells. Returns ((..., S, 2) cells,
    (..., S) step-valid mask) where S = max_steps. The reference normalizes
    the walk (steep swap, ascending x) and visits every x in [x0, x1]
    INCLUSIVE with y advanced by the accumulated-error rule; the k-th visited
    y has the closed form y0 + ystep·⌊(2k·Δy + Δx)/(2Δx)⌋, so all steps
    compute in parallel (no sequential carry)."""
    x0, y0 = c0[..., 0], c0[..., 1]
    x1, y1 = c1[..., 0], c1[..., 1]
    steep = jnp.abs(y1 - y0) > jnp.abs(x1 - x0)
    ax0 = jnp.where(steep, y0, x0)
    ay0 = jnp.where(steep, x0, y0)
    ax1 = jnp.where(steep, y1, x1)
    ay1 = jnp.where(steep, x1, y1)
    flip = ax0 > ax1
    bx0 = jnp.where(flip, ax1, ax0)
    by0 = jnp.where(flip, ay1, ay0)
    bx1 = jnp.where(flip, ax0, ax1)
    by1 = jnp.where(flip, ay0, ay1)
    dx = bx1 - bx0  # ≥ 0
    dy = jnp.abs(by1 - by0)
    ystep = jnp.where(by0 < by1, 1, -1)
    k = jnp.arange(max_steps, dtype=jnp.int32)
    shp = (1,) * (x0.ndim) + (max_steps,)
    k = k.reshape(shp)
    ok = k <= dx[..., None]
    dxe = jnp.maximum(dx, 1)[..., None]
    j = (2 * k * dy[..., None] + dxe) // (2 * dxe)
    # the error rule never advances past y1: with k ≤ dx, j ≤ dy by
    # construction (⌊(2·dx·dy + dx)/(2dx)⌋ = dy since dy ≤ dx)
    px = bx0[..., None] + k
    py = by0[..., None] + ystep[..., None] * j
    cx = jnp.where(steep[..., None], py, px)
    cy = jnp.where(steep[..., None], px, py)
    return jnp.stack([cx, cy], axis=-1), ok


def karto_counts_update_scan(
    pass_cnt: jax.Array,
    hit_cnt: jax.Array,
    cfg: GridConfig,
    origin_xy: jax.Array,
    endpoints: jax.Array,
    ranges: jax.Array,
    range_threshold: float,
    min_range: float,
    max_range: float,
    max_steps: int | None = None,
):
    """Karto AddScan → RayTrace → counters, EXACT semantics
    (Karto.h:5886-5950): skip r ≤ min / r ≥ max / NaN; clamp the ray at the
    range threshold (scale the world vector by threshold/r); TraceLine marks
    every visited in-bounds cell +1 pass INCLUSIVE of the endpoint cell; a
    valid endpoint (r < threshold − 1e-6) then adds ANOTHER pass and a hit
    at its cell. Cells follow math::Round (WorldToGrid). Validated
    cell-identical against the reference's OccupancyGrid::CreateFromScans
    (tests/test_golden_karto.py)."""
    w = cfg.size_x
    h = cfg.size_y
    if max_steps is None:
        max_steps = int(range_threshold / cfg.resolution * 1.5) + 4
    origin = jnp.asarray([cfg.origin_x, cfg.origin_y], endpoints.dtype)
    use = (
        jnp.isfinite(ranges)
        & (ranges > min_range)
        & (ranges < max_range)
    )
    end_valid = use & (ranges < (range_threshold - 1e-6))
    over = ranges >= range_threshold
    ratio = jnp.where(over, range_threshold / jnp.maximum(ranges, 1e-9), 1.0)
    d = endpoints - origin_xy[..., None, :]
    end = origin_xy[..., None, :] + ratio[..., None] * d
    c0 = kround_i((origin_xy - origin) / cfg.resolution)  # (..., 2)
    c1 = kround_i((end - origin) / cfg.resolution)  # (..., N, 2)
    c0b = jnp.broadcast_to(c0[..., None, :], c1.shape)
    cells, ok = bresenham_cells(c0b, c1, max_steps)  # (..., N, S, 2)
    inb = (
        (cells[..., 0] >= 0) & (cells[..., 0] < w)
        & (cells[..., 1] >= 0) & (cells[..., 1] < h)
    )
    keep = ok & inb & use[..., None]
    flat = jnp.where(
        keep, cells[..., 1] * w + cells[..., 0], OOB_INDEX
    )
    pass_cnt = pass_cnt.at[flat.reshape(-1)].add(1, mode="drop")
    # endpoint double-count: TraceLine already visited gridTo; a valid
    # endpoint increments pass AND hit once more (Karto.h:5929-5945)
    e_inb = (
        (c1[..., 0] >= 0) & (c1[..., 0] < w)
        & (c1[..., 1] >= 0) & (c1[..., 1] < h)
    )
    eflat = jnp.where(
        end_valid & e_inb, c1[..., 1] * w + c1[..., 0], OOB_INDEX
    )
    pass_cnt = pass_cnt.at[eflat.reshape(-1)].add(1, mode="drop")
    hit_cnt = hit_cnt.at[eflat.reshape(-1)].add(1, mode="drop")
    return pass_cnt, hit_cnt


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def karto_counts_windows(
    cfg: GridConfig,
    origin_xy: jax.Array,  # (T, 2) scan positions (world)
    endpoints: jax.Array,  # (T, N, 2) raw world endpoints
    ranges: jax.Array,  # (T, N) raw readings
    range_threshold: float,
    min_range: float,
    max_range: float,
) -> tuple[jax.Array, jax.Array]:
    """Whole-mission Karto counters as one-hot rasterization.

    Same EXACT cell semantics as karto_counts_update_scan, restructured to
    avoid one scatter-add of ~10⁷ single-cell updates per mission. Instead,
    each scan's rays are rasterized into a LOCAL (Wd × Wd) window around the
    scan position (every traced cell lies within the clamped range
    threshold of the scan) with two one-hot matrix products:

        window[y, x] = Σ_samples 1[y_s = y]·1[x_s = x]
                     = onehot_yᵀ @ onehot_x      (contraction over samples)

    and windows accumulate into the padded global grid with one
    dynamic-slice add per scan. 0/1 one-hots with f32 accumulation are
    exact (counts ≪ 2²⁴), and stay exact on a GPU: the operands are
    bfloat16, so TF32 never applies, and every 0/1 product is exact in any
    multiplier. The endpoint double-count rides along as one extra sample
    per beam.
    """
    w = cfg.size_x
    h = cfg.size_y
    dtype = endpoints.dtype
    T, N = ranges.shape
    margin = int(np.ceil(range_threshold / cfg.resolution)) + 2
    S = int(range_threshold / cfg.resolution * 1.5) + 4
    Wd = _round_up(2 * margin + 3, 128)
    P = Wd  # padding so window placement never clips
    origin = jnp.asarray([cfg.origin_x, cfg.origin_y], dtype)

    use = (
        jnp.isfinite(ranges) & (ranges > min_range) & (ranges < max_range)
    )
    end_valid = use & (ranges < (range_threshold - 1e-6))
    over = ranges >= range_threshold
    ratio = jnp.where(over, range_threshold / jnp.maximum(ranges, 1e-9), 1.0)
    d = endpoints - origin_xy[:, None, :]
    end = origin_xy[:, None, :] + ratio[..., None] * d
    c0 = kround_i((origin_xy - origin) / cfg.resolution)  # (T, 2)
    c1 = kround_i((end - origin) / cfg.resolution)  # (T, N, 2)
    wo = c0 - (margin + 1)  # (T, 2) window origin (global cells)

    def one_scan(c0_t, c1_t, wo_t, use_t, ev_t):
        cells, ok = bresenham_cells(
            jnp.broadcast_to(c0_t[None, :], c1_t.shape), c1_t, S
        )  # (N, S, 2)
        # trace samples + one endpoint sample per beam (the double count)
        tr = cells.reshape(-1, 2)
        keep_tr = (ok & use_t[:, None]).reshape(-1)
        samples = jnp.concatenate([tr, c1_t], axis=0)  # (N*S + N, 2)
        keep = jnp.concatenate([keep_tr, ev_t], axis=0)
        inb = (
            (samples[:, 0] >= 0) & (samples[:, 0] < w)
            & (samples[:, 1] >= 0) & (samples[:, 1] < h)
        )
        keep = keep & inb
        lx = samples[:, 0] - wo_t[0]
        ly = samples[:, 1] - wo_t[1]
        iy = jnp.arange(Wd, dtype=jnp.int32)
        oh_y = ((ly[:, None] == iy[None, :]) & keep[:, None]).astype(
            jnp.bfloat16
        )
        oh_x = (lx[:, None] == iy[None, :]).astype(jnp.bfloat16)
        win_pass = jax.lax.dot_general(
            oh_y, oh_x, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # (Wd, Wd) y-major
        # hits: endpoint samples only
        keep_e = ev_t & inb[N * S:]
        ohe_y = ((c1_t[:, 1] - wo_t[1])[:, None] == iy[None, :]) & keep_e[
            :, None
        ]
        ohe_x = (c1_t[:, 0] - wo_t[0])[:, None] == iy[None, :]
        win_hit = jax.lax.dot_general(
            ohe_y.astype(jnp.bfloat16), ohe_x.astype(jnp.bfloat16),
            (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        return win_pass.astype(jnp.int32), win_hit.astype(jnp.int32)

    def body(carry, inp):
        gp, gh = carry
        c0_t, c1_t, wo_t, use_t, ev_t = inp
        wp_, wh_ = one_scan(c0_t, c1_t, wo_t, use_t, ev_t)
        y0 = wo_t[1] + P
        x0 = wo_t[0] + P
        cur = jax.lax.dynamic_slice(gp, (y0, x0), (Wd, Wd))
        gp = jax.lax.dynamic_update_slice(gp, cur + wp_, (y0, x0))
        cur = jax.lax.dynamic_slice(gh, (y0, x0), (Wd, Wd))
        gh = jax.lax.dynamic_update_slice(gh, cur + wh_, (y0, x0))
        return (gp, gh), None

    gp0 = jnp.zeros((h + 2 * P, w + 2 * P), jnp.int32)
    gh0 = jnp.zeros((h + 2 * P, w + 2 * P), jnp.int32)
    (gp, gh), _ = jax.lax.scan(body, (gp0, gh0), (c0, c1, wo, use, end_valid))
    return gp[P : P + h, P : P + w], gh[P : P + h, P : P + w]


def karto_occupancy(
    pass_cnt: jax.Array,
    hit_cnt: jax.Array,
    min_pass_through: int = 2,
    occupancy_threshold: float = 0.1,
) -> jax.Array:
    """Karto cell state (UpdateCell, Karto.h:5953-5968): occupied iff
    pass > MinPassThrough ∧ hit/pass > OccupancyThreshold (both STRICT);
    free iff passed; else unknown. int8: -1 unknown, 0 free, 100 occupied."""
    passed = pass_cnt > min_pass_through
    frac = hit_cnt / jnp.maximum(pass_cnt, 1)
    occ = passed & (frac > occupancy_threshold)
    return jnp.where(occ, 100, jnp.where(passed, 0, -1)).astype(jnp.int8)


def logodds_to_ros(
    grid: jax.Array, obstacle_threshold: float = 0.0
) -> jax.Array:
    """Hector grid → nav_msgs-style int8 map (hector_slam.cc:270-317):
    occupied→100, free→0, untouched→-1. One device op replacing the
    ~50 ms/publish conversion loop (SURVEY §6)."""
    occupied = grid > obstacle_threshold
    free = grid < 0.0
    touched = grid != 0.0
    return jnp.where(
        occupied, 100, jnp.where(free & touched, 0, -1)
    ).astype(jnp.int8)
