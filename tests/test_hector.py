import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_slam.config import GridConfig, SLAMConfig, default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan, index_scan
from tpu_slam.models.gmapping import GMapping
from tpu_slam.models.hector_slam import HectorSLAM, build_pyramid_cfgs
from tpu_slam.ops.hector import interp_map_with_derivs, match_multires
from tpu_slam.utils.evaluation import ate_rmse


def small_cfg():
    cfg = default_config()
    return dataclasses.replace(
        cfg,
        hector=dataclasses.replace(
            cfg.hector, map_size=256, map_resolution=0.05,
            map_multi_res_levels=3,
        ),
    )


def test_bilinear_interp_values_and_grads():
    size = 8
    grid = np.zeros((size, size), np.float32)
    grid[3, 4] = 1.0  # prob 1 at (x=4, y=3)
    flat = jnp.asarray(grid.reshape(-1))
    # at the cell itself
    v, dx, dy = interp_map_with_derivs(flat, size, size, jnp.array([4.0, 3.0]))
    np.testing.assert_allclose(float(v), 1.0, atol=1e-6)
    # halfway towards +x neighbor: v=0.5; bilinear grads within the
    # [4,5)×[3,4) cell: dx = p10−p00 = −1, dy = (1−fx)(p01−p00)+fx(p11−p10)
    v, dx, dy = interp_map_with_derivs(flat, size, size, jnp.array([4.5, 3.0]))
    np.testing.assert_allclose(float(v), 0.5, atol=1e-6)
    np.testing.assert_allclose(float(dx), -1.0, atol=1e-6)
    np.testing.assert_allclose(float(dy), -0.5, atol=1e-6)
    # out of bounds → zeros
    v, dx, dy = interp_map_with_derivs(flat, size, size, jnp.array([9.0, 3.0]))
    assert float(v) == 0.0 and float(dx) == 0.0


def test_finite_difference_gradients(rng):
    size = 16
    grid = jnp.asarray(rng.uniform(0, 1, (size * size,)), jnp.float32)
    # keep sample points off cell boundaries: bilinear grads are
    # discontinuous there and the FD probe must stay inside one cell
    base = rng.integers(2, 12, (50, 2))
    frac = rng.uniform(0.2, 0.7, (50, 2))
    pts = jnp.asarray(base + frac, jnp.float32)
    v, dx, dy = interp_map_with_derivs(grid, size, size, pts)
    eps = 1e-2
    vx1, _, _ = interp_map_with_derivs(
        grid, size, size, pts + jnp.array([eps, 0.0])
    )
    vy1, _, _ = interp_map_with_derivs(
        grid, size, size, pts + jnp.array([0.0, eps])
    )
    np.testing.assert_allclose(
        np.asarray((vx1 - v) / eps), np.asarray(dx), atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray((vy1 - v) / eps), np.asarray(dy), atol=1e-2
    )


def test_pyramid_cfgs():
    cfg = small_cfg()
    g = build_pyramid_cfgs(cfg)
    assert len(g) == 3
    assert g[0].resolution == 0.05 and g[0].size_x == 256
    assert g[1].resolution == 0.1 and g[1].size_x == 128
    assert g[2].resolution == 0.2 and g[2].size_x == 64
    # same world footprint
    assert g[0].origin_x == g[1].origin_x == g[2].origin_x


@pytest.fixture(scope="module")
def hector_seq():
    cfg = small_cfg()
    traj = sim.circle_trajectory(60, radius=1.5, angular_rate=0.6)
    world = sim.office_world(seed=31, size=10.0, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=3)
    scans = make_scan(seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32))
    return cfg, scans, seq


def test_hector_sampling_covariance(hector_seq):
    """Sampling-based sigma-point covariance (getCovarianceForPose,
    OccGridMapUtil.h:249-306): matches a direct numpy replica of the
    reference's weighted-moment formula and is symmetric PSD."""
    from tpu_slam.ops import gridmap as gm
    from tpu_slam.ops.hector import (
        likelihood_for_state, sampling_covariance, world_pose_to_map,
    )

    cfg, scans, seq = hector_seq
    slam = HectorSLAM(cfg)
    for t in range(3):
        slam.update_only(index_scan(scans, t), seq.gt_poses[t])
    slam.last_pose = jnp.asarray(seq.gt_poses[3], jnp.float32)
    s = index_scan(scans, 3)

    cov = slam.sampling_covariance(s)
    assert cov.shape == (3, 3)
    np.testing.assert_allclose(cov, cov.T, atol=1e-8)
    assert np.all(np.linalg.eigvalsh(cov) >= -1e-8)
    assert np.all(np.diag(cov) > 0)

    # numpy replica of the reference math at level 0, in map coords
    gc = slam.grid_cfgs[0]
    prob = gm.occupancy_prob(slam.grids[0])
    pm = np.asarray(world_pose_to_map(gc, slam.last_pose))
    pts = jnp.where(s.valid[..., None], s.points(), 0.0) / gc.resolution
    x, y, a = pm
    sig = np.array([
        [x + 1.5, y, a], [x - 1.5, y, a], [x, y + 1.5, a],
        [x, y - 1.5, a], [x, y, a + 0.05], [x, y, a - 0.05], [x, y, a],
    ], np.float32)
    lh = np.array([
        float(likelihood_for_state(
            prob, gc.size_x, gc.size_y, jnp.asarray(p), pts, s.valid
        ))
        for p in sig
    ])
    wn = lh / lh.sum()
    mean = (wn[:, None] * sig).sum(0)
    d = sig - mean
    ref_cov_map = np.einsum("k,ki,kj->ij", wn, d, d)
    sc = np.array([gc.resolution, gc.resolution, 1.0])
    np.testing.assert_allclose(
        cov, ref_cov_map * np.outer(sc, sc), rtol=1e-4, atol=1e-10
    )
    # the center sigma point should be the most likely state
    assert lh[6] >= lh[:6].max() - 1e-6


def test_hector_slam_tracks(hector_seq):
    cfg, scans, seq = hector_seq
    slam = HectorSLAM(cfg)
    # start at gt start pose so map frame == world frame for ATE w/o align
    slam.last_pose = jnp.asarray(seq.gt_poses[0], jnp.float32)
    est = slam.run(scans)
    ate = ate_rmse(est, seq.gt_poses, align=False)
    assert ate < 0.06, f"hector ATE {ate:.4f}"


def test_hector_map_quality(hector_seq):
    cfg, scans, seq = hector_seq
    slam = HectorSLAM(cfg)
    slam.last_pose = jnp.asarray(seq.gt_poses[0], jnp.float32)
    slam.run(scans)
    m = slam.to_ros_map()
    # a meaningful map: some occupied walls, plenty of free space, unknown rest
    assert (m == 100).sum() > 100
    assert (m == 0).sum() > 5000
    assert (m == -1).sum() > 1000


def test_hector_map_only_node(hector_seq):
    """The lesson4 hector_mapping node: fixed-pose map updates."""
    cfg, scans, seq = hector_seq
    slam = HectorSLAM(cfg)
    for t in range(0, 20):
        slam.update_only(index_scan(scans, t), seq.gt_poses[t])
    m = slam.to_ros_map()
    assert (m == 100).sum() > 50


def test_gmapping_map(hector_seq):
    cfg, scans, seq = hector_seq
    g = GMapping(cfg)
    g.run(scans, seq.gt_poses.astype(np.float32))
    m = g.to_ros_map()
    assert (m == 100).sum() > 100
    assert (m == 0).sum() > 5000
    # occupancy fraction rule: hit cells along walls are stable across scans
    assert (m == -1).sum() > 1000

    # PointAccumulator::mean (grid/map.h:17-48): each hit cell's mean hit
    # position must lie within that cell's bounds
    means = g.cell_means()
    hits2d = np.asarray(g.hits).reshape(m.shape)
    ys, xs = np.nonzero(hits2d > 0)
    gc = cfg.grid
    # cell ix spans world [origin + ix·res, origin + (ix+1)·res)
    cx = gc.origin_x + (xs + 0.5) * gc.resolution
    cy = gc.origin_y + (ys + 0.5) * gc.resolution
    mx = means[ys, xs, 0]
    my = means[ys, xs, 1]
    pad = gc.resolution * 0.51  # half-cell + fp slack
    assert np.all(np.abs(mx - cx) <= pad)
    assert np.all(np.abs(my - cy) <= pad)


def test_sampling_covariance_off_map_is_finite():
    """All-zero sigma-point likelihoods (pose off the map) must yield a
    finite (large) covariance, not NaN."""
    cfg = small_cfg()
    slam = HectorSLAM(cfg)
    slam.last_pose = jnp.asarray([1e3, 1e3, 0.0], jnp.float32)  # off-map
    world = sim.office_world(seed=3)
    traj = sim.circle_trajectory(2, radius=1.0)
    seq = sim.simulate_sequence(world, traj, cfg.scan, seed=0)
    s = index_scan(make_scan(seq.ranges, cfg.scan), 0)
    cov = slam.sampling_covariance(s)
    assert np.isfinite(cov).all()
    assert np.all(np.diag(cov) >= 0)


@pytest.mark.slow
def test_hector_mesh_pipeline_matches_single_device(hector_seq):
    """HectorSLAM(cfg, mesh=...): row-stripe-sharded map pyramid (halo GN
    match + no-communication sharded rasterizer) must reproduce the
    single-device mission — trajectory AND final map (spatial
    parallelism wired into the flagship pipeline)."""
    from tpu_slam.parallel.mesh import make_mesh

    cfg, scans, seq = hector_seq
    ref = HectorSLAM(cfg)
    ref.last_pose = jnp.asarray(seq.gt_poses[0], jnp.float32)
    est_ref = ref.run(scans)

    slam = HectorSLAM(cfg, mesh=make_mesh())
    slam.last_pose = jnp.asarray(seq.gt_poses[0], jnp.float32)
    est = slam.run(scans)

    np.testing.assert_allclose(est, est_ref, atol=1e-4)
    np.testing.assert_array_equal(slam.to_ros_map(), ref.to_ros_map())
