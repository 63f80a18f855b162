import jax.numpy as jnp
import numpy as np
import pytest

from tpu_slam import geometry as geo
from tpu_slam.config import ICPConfig, PLICPConfig, ScanConfig, default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan, index_scan
from tpu_slam.ops.icp import icp_match
from tpu_slam.ops.matching import masked_quantile, nearest_neighbor
from tpu_slam.ops.plicp import plicp_match


def two_scans(seed=0, delta=(0.08, -0.05, 0.06), n=360):
    """Render the same world from two poses; matcher must recover delta."""
    cfg = ScanConfig(num_beams=n)
    world = sim.office_world(seed=seed)
    p0 = np.array([0.3, -0.2, 0.4])
    p1 = np.asarray(geo.compose(jnp.asarray(p0), jnp.asarray(delta, dtype=jnp.float64)))
    seq = sim.simulate_sequence(
        world, np.stack([p0, p1]), cfg, noise_std=0.002, seed=seed
    )
    scans = make_scan(seq.ranges, cfg)
    return index_scan(scans, 1), index_scan(scans, 0), np.asarray(delta)


def test_nearest_neighbor_masked():
    src = jnp.array([[0.0, 0.0]])
    tgt = jnp.array([[0.1, 0.0], [5.0, 5.0], [0.01, 0.0]])
    valid = jnp.array([True, True, False])
    idx, d2 = nearest_neighbor(src, tgt, valid)
    assert int(idx[0]) == 0  # masked closer point ignored
    np.testing.assert_allclose(float(d2[0]), 0.01, atol=1e-6)


def test_masked_quantile():
    x = jnp.array([5.0, 1.0, 3.0, 2.0, 4.0, 99.0])
    m = jnp.array([True, True, True, True, True, False])
    assert float(masked_quantile(x, m, 1.0)) == 5.0
    assert float(masked_quantile(x, m, 0.0)) == 1.0
    assert float(masked_quantile(x, m, 0.5)) == 3.0


def test_icp_recovers_small_motion():
    src, tgt, delta = two_scans(delta=(0.05, 0.02, 0.03))
    pose, err, n = icp_match(
        src.points(), src.valid, tgt.points(), tgt.valid, ICPConfig()
    )
    np.testing.assert_allclose(np.asarray(pose), delta, atol=0.02)
    assert int(n) > 100


def test_plicp_recovers_motion():
    src, tgt, delta = two_scans(delta=(0.08, -0.05, 0.06))
    res = plicp_match(
        src.points(), src.valid, tgt.points(), tgt.valid, PLICPConfig()
    )
    np.testing.assert_allclose(np.asarray(res.pose), delta, atol=0.01)
    assert int(res.num_inliers) > 100
    assert bool(res.converged)


def test_plicp_uses_init_pose_for_larger_motion():
    src, tgt, delta = two_scans(delta=(0.35, 0.1, 0.25))
    init = jnp.asarray(delta + np.array([0.03, -0.02, 0.02]), jnp.float32)
    res = plicp_match(
        src.points(), src.valid, tgt.points(), tgt.valid, PLICPConfig(),
        init_pose=init,
    )
    np.testing.assert_allclose(np.asarray(res.pose), delta, atol=0.015)


def test_plicp_more_accurate_than_icp():
    """The lesson3 claim: PL-ICP beats point-to-point ICP on accuracy."""
    errs = {"icp": [], "plicp": []}
    for seed in range(3):
        src, tgt, delta = two_scans(seed=seed, delta=(0.1, 0.04, 0.08))
        p_icp, _, _ = icp_match(
            src.points(), src.valid, tgt.points(), tgt.valid, ICPConfig()
        )
        r = plicp_match(
            src.points(), src.valid, tgt.points(), tgt.valid, PLICPConfig()
        )
        errs["icp"].append(np.linalg.norm(np.asarray(p_icp)[:2] - delta[:2]))
        errs["plicp"].append(np.linalg.norm(np.asarray(r.pose)[:2] - delta[:2]))
    assert np.mean(errs["plicp"]) <= np.mean(errs["icp"]) + 1e-4


def test_plicp_batched():
    import jax

    pairs = [two_scans(seed=s, delta=(0.06, -0.02, 0.04)) for s in range(4)]
    sp = jnp.stack([p[0].points() for p in pairs])
    sv = jnp.stack([p[0].valid for p in pairs])
    tp = jnp.stack([p[1].points() for p in pairs])
    tv = jnp.stack([p[1].valid for p in pairs])
    res = plicp_match(sp, sv, tp, tv, PLICPConfig())
    assert res.pose.shape == (4, 3)
    for i, (_, _, delta) in enumerate(pairs):
        np.testing.assert_allclose(np.asarray(res.pose[i]), delta, atol=0.01)


def test_plicp_point_to_point_config():
    """use_point_to_line_distance=0 → vanilla ICP inside the CSM loop
    (plicp_odometry.cc:128-130)."""
    import dataclasses

    src, tgt, delta = two_scans(delta=(0.05, 0.02, 0.03))
    cfg = dataclasses.replace(PLICPConfig(), use_point_to_line_distance=False)
    res = plicp_match(src.points(), src.valid, tgt.points(), tgt.valid, cfg)
    np.testing.assert_allclose(np.asarray(res.pose), delta, atol=0.03)


def test_scan_match_plicp_node():
    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.models.scan_match_plicp import ScanMatchPLICP

    cfg = default_config()
    traj = sim.circle_trajectory(10, radius=1.5, angular_rate=0.6)
    world = sim.office_world(seed=7, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.003, seed=1)
    node = ScanMatchPLICP(cfg)
    node.run(make_scan(seq.ranges, cfg.scan))
    # accumulated frame-to-frame pose ends near gt relative motion
    gt_rel = np.asarray(
        geo.relative(jnp.asarray(seq.gt_poses[0]), jnp.asarray(seq.gt_poses[-1]))
    )
    np.testing.assert_allclose(node.pose, gt_rel, atol=0.03)


def _primitives(jaxpr):
    """Every primitive name in a jaxpr, sub-jaxprs included."""
    import jax

    out = set()
    for eqn in jaxpr.eqns:
        out.add(eqn.primitive.name)
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out |= _primitives(sub)
    return out


def test_nearest_neighbor_has_no_tf32_eligible_product():
    """The NN distances feed an argmin: on a GPU a float32 matrix product
    may run in TF32, so the search must be pure elementwise arithmetic."""
    import jax

    src = jnp.zeros((4, 360, 2))
    tgt = jnp.zeros((4, 360, 2))
    tv = jnp.ones((4, 360), bool)
    prims = _primitives(
        jax.make_jaxpr(nearest_neighbor)(src, tgt, tv).jaxpr)
    assert "argmin" in prims
    assert not prims & {"dot_general", "conv_general_dilated"}, prims


def test_nearest_neighbor_exact_at_long_range():
    """At a 12 m range the expanded |a|²+|b|²−2a·b form loses the
    difference between adjacent beams; exact differences keep it."""
    th = np.linspace(0.5, 0.5 + 2 * np.pi / 360 * 8, 9)
    tgt = np.stack([12 * np.cos(th), 12 * np.sin(th)], -1).astype(np.float32)
    mid = 0.5 * (tgt[3] + tgt[4])
    src = (mid + 0.1 * (tgt[4] - tgt[3]))[None].astype(np.float32)
    idx, d2 = nearest_neighbor(
        jnp.asarray(src), jnp.asarray(tgt), jnp.ones(9, bool))
    assert int(idx[0]) == 4
    want = float(np.sum((src[0].astype(np.float64) - tgt[4]) ** 2))
    assert float(d2[0]) == pytest.approx(want, rel=1e-4)
