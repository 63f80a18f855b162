import math

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_slam import geometry as geo
from tpu_slam.config import ScanConfig
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan, index_scan, world_points
from tpu_slam.ops.correlative import (
    CorrelativeMatcher,
    CorrelativeParams,
    _lattice_stride,
    _responses_for_angles,
    _responses_sliced,
    build_correlation_grid,
    find_valid_points,
    smear_kernel,
)


def params(search=0.3, res=0.02, rng_th=5.0):
    return CorrelativeParams(
        search_size=search,
        resolution=res,
        smear_deviation=0.03,
        range_threshold=rng_th,
        angle_offset=math.radians(20.0),
        angle_res=math.radians(2.0),
        fine_angle_offset=math.radians(0.2),
    )


def test_smear_kernel_shape_and_center():
    p = params()
    k = smear_kernel(p)
    h = p.half_kernel
    assert k.shape == (2 * h + 1, 2 * h + 1)
    assert k[h, h] == 100
    assert k[0, 0] < k[h, h]
    # matches reference formula at one offset
    d = math.hypot(1 * p.resolution, 2 * p.resolution)
    want = round(math.exp(-0.5 * (d / p.smear_deviation) ** 2) * 100)
    assert k[h + 1, h + 2] == want


def test_build_grid_smears():
    p = params()
    center = jnp.zeros(2)
    pts = jnp.array([[0.5, 0.0]])
    grid = np.asarray(
        build_correlation_grid(p, center, pts, jnp.array([True]))
    )
    c = p.center_cell
    cx = c + round(0.5 / p.resolution)
    assert grid[c, cx] == 100  # [row=y, col=x]
    assert 0 < grid[c + 1, cx] < 100
    assert grid[c, cx + p.half_kernel + 1] == 0


def test_find_valid_points_keeps_ccw():
    """Points swept counterclockwise around the viewpoint are kept."""
    th = np.linspace(0, np.pi, 50)
    pts = jnp.asarray(np.stack([2 * np.cos(th), 2 * np.sin(th)], -1))
    valid = jnp.ones(50, bool)
    keep = find_valid_points(pts, valid, jnp.zeros(2))
    assert np.asarray(keep).mean() > 0.9
    # clockwise sweep → dropped
    keep_cw = find_valid_points(pts[::-1], valid, jnp.zeros(2))
    assert np.asarray(keep_cw).mean() < 0.3


def test_lattice_stride_tolerates_f32_jitter():
    """Offset tables built as -half + i*step in float32 wobble at the 1e-7
    level; the stride detector must still see the integer lattice (a miss
    silently lands on the ~16x slower gather path)."""
    res = 0.05
    n = 81
    half = 0.5 * (161 - 1) * res
    xo = np.asarray([-half + i * 2.0 * res for i in range(n)], np.float32)
    assert _lattice_stride(xo, xo.copy(), res) == 2
    fine = np.asarray([-res, 0.0, res], np.float32)
    assert _lattice_stride(fine, fine.copy(), res) == 1
    # genuinely non-uniform or off-lattice offsets are rejected
    assert _lattice_stride(np.array([0.0, 0.05, 0.2]), xo, res) is None
    assert _lattice_stride(np.array([0.0, 0.07]), np.array([0.0, 0.07]), res) is None


def test_response_paths_bit_identical():
    """The numerator implementations (random gather, batched window loads)
    must agree bit-for-bit — both reproduce the reference's int32 response
    sums (GetResponse, Mapper.cpp:819-856)."""
    rng = np.random.default_rng(7)
    p = params(search=1.6, res=0.05, rng_th=3.0)
    g = p.grid_size
    w8 = p.row_stride
    grid_np = np.zeros((g, w8), np.int32)
    grid_np[:, :g] = rng.integers(0, 101, size=(g, g), dtype=np.int32)
    grid = jnp.asarray(grid_np)
    n = 96
    r = rng.uniform(0.3, 2.9, n)
    th = rng.uniform(-np.pi, np.pi, n)
    pts_cells = jnp.asarray(
        (np.stack([r * np.cos(th), r * np.sin(th)], -1) / p.resolution)
        .astype(np.float32)
    )
    beam_valid = jnp.asarray(rng.random(n) > 0.1)
    angles = jnp.asarray(
        np.linspace(-0.3, 0.3, 9).astype(np.float32)
    )
    n_x = n_y = p.n_search // 2  # stride-2 coarse lattice
    stride = 2
    cand0 = jnp.asarray(
        [p.center_cell - (n_x // 2) * stride] * 2, jnp.int32
    )
    cells = np.arange(n_x) * stride + int(cand0[0])
    cand_flat = (
        cells[:, None] * w8 + cells[None, :]
    ).reshape(-1).astype(np.int32)  # y-major (rows=y)

    gather = np.asarray(
        _responses_for_angles(
            grid.reshape(-1), g, w8, pts_cells, beam_valid, angles,
            jnp.asarray(cand_flat),
        )
    )
    sliced = np.asarray(
        _responses_sliced(
            grid, pts_cells, beam_valid, angles, cand0, n_x, n_y, stride
        )
    )
    np.testing.assert_array_equal(gather, sliced)


@pytest.fixture(scope="module")
def match_setup():
    scan_cfg = ScanConfig(num_beams=360, range_max=6.0, range_threshold=5.0)
    world = sim.office_world(seed=41, size=8.0, n_boxes=6)
    pose_a = np.array([0.2, -0.1, 0.3])
    delta = np.array([0.08, -0.06, 0.05])
    pose_b = np.asarray(
        geo.compose(jnp.asarray(pose_a), jnp.asarray(delta))
    )
    seq = sim.simulate_sequence(
        world, np.stack([pose_a, pose_b]), scan_cfg, noise_std=0.003, seed=2
    )
    scans = make_scan(seq.ranges, scan_cfg)
    return scan_cfg, scans, pose_a, pose_b


def test_correlative_match_recovers_pose(match_setup):
    scan_cfg, scans, pose_a, pose_b = match_setup
    p = params()
    m = CorrelativeMatcher(p)
    sa, sb = index_scan(scans, 0), index_scan(scans, 1)
    base_pts = world_points(sa, jnp.asarray(pose_a, jnp.float32))
    base_valid = sa.valid & (sa.ranges <= p.range_threshold)
    beam_valid = sb.valid & (sb.ranges <= p.range_threshold)
    pts_l = jnp.where(beam_valid[..., None], sb.points(), 0.0)
    # search centered at a perturbed odometry guess
    guess = jnp.asarray(pose_b + np.array([0.05, -0.04, 0.04]), jnp.float32)
    res = m.match(base_pts, base_valid, pts_l, beam_valid, guess)
    err = np.asarray(res.pose) - pose_b
    assert abs(err[0]) < 0.02 and abs(err[1]) < 0.02
    assert abs(err[2]) < math.radians(1.0)
    assert float(res.response) > 0.5
    cov = np.asarray(res.covariance)
    assert cov[0, 0] < 0.1 and cov[1, 1] < 0.1 and cov[2, 2] < 0.1


def test_correlative_match_identity(match_setup):
    """Matching a scan against its own rasterization at the true pose."""
    scan_cfg, scans, pose_a, pose_b = match_setup
    p = params()
    m = CorrelativeMatcher(p)
    sa = index_scan(scans, 0)
    base_valid = sa.valid & (sa.ranges <= p.range_threshold)
    base_pts = world_points(sa, jnp.asarray(pose_a, jnp.float32))
    pts_l = jnp.where(base_valid[..., None], sa.points(), 0.0)
    res = m.match(
        base_pts, base_valid, pts_l, base_valid,
        jnp.asarray(pose_a, jnp.float32),
    )
    err = np.asarray(res.pose) - pose_a
    assert abs(err[0]) < 0.015 and abs(err[1]) < 0.015
    # responses normalize by the TOTAL beam count (reference GetResponse
    # nPoints, Mapper.cpp:852), so invalid beams cap the self-match response
    # at n_valid/n_total
    frac_valid = float(np.asarray(base_valid).mean())
    assert float(res.response) > 0.9 * frac_valid


def test_response_expansion_recovers_large_rotation(match_setup):
    """Initial heading off by 35° (> coarse window 20°): the response
    expansion (Mapper.cpp:242-272) must still find the pose."""
    scan_cfg, scans, pose_a, pose_b = match_setup
    p = params()
    m = CorrelativeMatcher(p)
    sa, sb = index_scan(scans, 0), index_scan(scans, 1)
    base_pts = world_points(sa, jnp.asarray(pose_a, jnp.float32))
    base_valid = sa.valid & (sa.ranges <= p.range_threshold)
    beam_valid = sb.valid & (sb.ranges <= p.range_threshold)
    pts_l = jnp.where(beam_valid[..., None], sb.points(), 0.0)
    guess = jnp.asarray(
        pose_b + np.array([0.0, 0.0, math.radians(35.0)]), jnp.float32
    )
    res = m.match(base_pts, base_valid, pts_l, beam_valid, guess)
    # note: with penalties the wide-angle true pose may score below
    # closer-but-wrong candidates; the reference has the same behavior.
    # We only require the expansion to produce a nonzero response.
    assert float(res.response) > 0.0


@pytest.mark.slow
def test_match_chains_equals_sequential(match_setup):
    """The batched multi-chain program (one dispatch for C chains) must
    reproduce the sequential per-chain MatchScan results exactly, including
    the fused world-transform + FindValidPoints view filter."""
    scan_cfg, scans, pose_a, pose_b = match_setup
    p = params()
    m = CorrelativeMatcher(p, use_response_expansion=False)
    sa, sb = index_scan(scans, 0), index_scan(scans, 1)
    beam_valid = np.asarray(sb.valid & (sb.ranges <= p.range_threshold))
    pts_l = np.where(beam_valid[..., None], np.asarray(sb.points()), 0.0)
    guess = np.asarray(pose_b + np.array([0.05, -0.04, 0.04]), np.float32)

    # three "chains": scan a at its pose, scan b at a nearby pose, and a
    # two-scan chain — plus one padded-invalid lane
    va = np.asarray(sa.valid & (sa.ranges <= p.range_threshold))
    pa = np.where(va[..., None], np.asarray(sa.points()), 0.0).astype(
        np.float32
    )
    vb = beam_valid
    pb = pts_l.astype(np.float32)
    n = pa.shape[0]
    C, S = 4, 2
    poses = np.zeros((C, S, 3), np.float32)
    pts = np.zeros((C, S, n, 2), np.float32)
    valid = np.zeros((C, S, n), bool)
    poses[0, 0] = pose_a
    pts[0, 0], valid[0, 0] = pa, va
    poses[1, 0] = pose_b + np.array([0.03, 0.02, 0.01])
    pts[1, 0], valid[1, 0] = pb, vb
    poses[2, 0], poses[2, 1] = poses[0, 0], poses[1, 0]
    pts[2, 0], pts[2, 1] = pa, pb
    valid[2, 0], valid[2, 1] = va, vb
    lane_valid = np.array([True, True, True, False])

    batched = m.match_chains(
        poses, pts, valid, pts_l.astype(np.float32), beam_valid, guess,
        do_penalize=False, lane_valid=lane_valid,
    )

    from tpu_slam.ops.correlative import find_valid_points as fvp

    for k in range(3):
        wp_list, kp_list = [], []
        for j in range(S):
            wp = geo.apply(
                jnp.asarray(poses[k, j]), jnp.asarray(pts[k, j])
            )
            kp = fvp(wp, jnp.asarray(valid[k, j]), jnp.asarray(guess[:2]))
            wp_list.append(np.asarray(wp))
            kp_list.append(np.asarray(kp))
        base_pts = np.concatenate(wp_list)
        base_keep = np.concatenate(kp_list)
        seq = m.match(
            jnp.asarray(base_pts), jnp.asarray(base_keep),
            jnp.asarray(pts_l, jnp.float32), jnp.asarray(beam_valid),
            jnp.asarray(guess), do_penalize=False,
        )
        np.testing.assert_allclose(
            batched.pose[k], np.asarray(seq.pose), atol=1e-5
        )
        np.testing.assert_allclose(
            batched.response[k], float(seq.response), atol=1e-6
        )
        np.testing.assert_allclose(
            batched.covariance[k], np.asarray(seq.covariance), atol=1e-4
        )
    # padded lane: empty grid → zero response, MAX_VARIANCE covariance
    assert batched.response[3] == 0.0
