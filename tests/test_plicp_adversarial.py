"""Adversarial CSM-deviation suite.

tpu_slam's PL-ICP reproduces the CSM subset that drives the lesson
trajectories (ops/plicp.py); it deliberately omits Censi's closed-form
covariance, correspondence clustering/orientation neighborhoods, the
visibility test, and restart-on-error (all disabled or trajectory-neutral
in the reference runs, plicp_odometry.cc:103-156; PARITY.md deviation 3).
These tests probe exactly the geometry where those omissions would show:

  * corridors — translation along the corridor axis is unobservable; the
    returned covariance must SAY so (large eigenvalue along the axis),
    and the observable directions (lateral, heading) must stay locked.
    This is the reference's own documented failure mode (README.md:100
    "长走廊" — long corridors defeat PL-ICP odometry).
  * rotationally-symmetric arenas — heading is unobservable; σ_θθ must
    dominate the well-constrained case by orders of magnitude.
  * cluttered scans with a moving object — the percentile/adaptive
    trimming (CSM outliers_maxPerc/adaptive, plicp_odometry.cc:139-156)
    must reject the coherent outlier block.

If these pass, the GN covariance σ²H⁻¹ is behaving the way Censi's
covariance is used by the downstream consumers (solver edge weighting):
blowing up along degenerate directions and staying tight elsewhere.
"""

import dataclasses
import math

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_slam.config import default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan
from tpu_slam.ops.plicp import plicp_match


def _cfg():
    cfg = default_config()
    return dataclasses.replace(
        cfg.scan, num_beams=360, range_max=20.0, range_threshold=20.0
    ), cfg.plicp


def _scan_pts(world, poses, scan_cfg, noise=0.002, seed=0):
    seq = sim.simulate_sequence(
        world, np.asarray(poses, np.float64), scan_cfg,
        noise_std=noise, seed=seed,
    )
    scans = make_scan(seq.ranges, scan_cfg)
    pts = np.asarray(scans.points())
    valid = np.asarray(scans.valid)
    pts = np.where(valid[..., None] & np.isfinite(pts), pts, 0.0)
    return (
        jnp.asarray(pts, jnp.float32),
        jnp.asarray(valid),
    )


def corridor_world(length=40.0, half_width=1.5):
    return (
        sim.World(segments=np.zeros((0, 4)))
        .add_segment(-length, -half_width, length, -half_width)
        .add_segment(-length, half_width, length, half_width)
    )


def polygon_arena(n_sides=180, radius=4.0):
    w = sim.World(segments=np.zeros((0, 4)))
    th = np.linspace(0, 2 * np.pi, n_sides + 1)
    for a, b in zip(th[:-1], th[1:]):
        w = w.add_segment(
            radius * np.cos(a), radius * np.sin(a),
            radius * np.cos(b), radius * np.sin(b),
        )
    return w


def _match(world, pose_a, pose_b, noise=0.002, seed=0):
    scan_cfg, pcfg = _cfg()
    pts, valid = _scan_pts(
        world, [pose_a, pose_b], scan_cfg, noise=noise, seed=seed
    )
    res = plicp_match(pts[1], valid[1], pts[0], valid[0], pcfg)
    return res


def test_corridor_covariance_flags_degenerate_axis():
    """Moving along an infinite corridor: the along-axis translation is
    unobservable. The covariance's dominant eigenvector must align with
    the corridor axis, with a large conditioning ratio — the downstream
    behavior Censi's covariance exists for."""
    res = _match(corridor_world(), [0, 0, 0], [0.3, 0.0, 0.0])
    cov_xy = np.asarray(res.covariance)[:2, :2]
    evals, evecs = np.linalg.eigh(cov_xy)
    v_max = evecs[:, np.argmax(evals)]
    assert abs(v_max[0]) > 0.95, f"dominant axis {v_max} not the corridor x"
    assert evals.max() > 50 * evals.min(), evals


def test_corridor_observable_directions_locked():
    """Same corridor: lateral offset and heading ARE observable and must
    be recovered tightly even though the along-axis shift is not."""
    res = _match(corridor_world(), [0, 0, 0], [0.4, 0.05, 0.01])
    pose = np.asarray(res.pose)
    # y and θ of the correction must match the true relative pose
    assert abs(pose[1] - 0.05) < 0.01, pose
    assert abs(pose[2] - 0.01) < 0.005, pose


def test_corridor_heading_variance_small():
    """Corridor walls constrain heading strongly: σ_θθ must be orders of
    magnitude below the degenerate translation variance."""
    res = _match(corridor_world(), [0, 0, 0], [0.3, 0.0, 0.0])
    cov = np.asarray(res.covariance)
    assert cov[2, 2] * 100 < cov[0, 0], cov.diagonal()


def test_rotational_symmetry_flags_heading():
    """A (near-)circular arena: heading is unobservable. σ_θθ must blow
    up relative to the same matcher in a heading-constrained world."""
    sym = _match(polygon_arena(), [0, 0, 0], [0, 0, 0.05], noise=0.004)
    box = sim.World.box(-3, -3, 3, 3)
    ref = _match(box, [0, 0, 0], [0, 0, 0.05], noise=0.004)
    s_sym = float(np.asarray(sym.covariance)[2, 2])
    s_ref = float(np.asarray(ref.covariance)[2, 2])
    # the arena's residual facet + noise structure keeps σ_θθ finite;
    # the signal is the order-of-magnitude blow-up vs the constrained box
    assert s_sym > 15 * s_ref, (s_sym, s_ref)
    # translation stays observable in the arena (distance to walls)
    cov_xy = np.asarray(sym.covariance)[:2, :2]
    assert np.linalg.eigvalsh(cov_xy).max() < s_sym


def test_well_constrained_scene_tight():
    """Boxy scene, fully constrained: pose recovered to millimeters, no
    spurious degeneracy reported."""
    world = sim.office_world(seed=7, size=8.0)
    res = _match(world, [0, 0, 0], [0.12, 0.06, 0.03])
    pose = np.asarray(res.pose)
    assert np.allclose(pose[:2], [0.12, 0.06], atol=0.01), pose
    assert abs(pose[2] - 0.03) < 0.005, pose
    cov_xy = np.asarray(res.covariance)[:2, :2]
    evals = np.linalg.eigvalsh(cov_xy)
    assert evals.max() < 100 * evals.min(), evals


def test_outlier_block_trimmed():
    """A coherent 15% block of displaced points (a passing object) must be
    rejected by the percentile/adaptive trimming, keeping the pose tight —
    the role of CSM's outlier tricks (plicp_odometry.cc:139-156)."""
    scan_cfg, pcfg = _cfg()
    world = sim.office_world(seed=9, size=8.0)
    pts, valid = _scan_pts(
        world, [[0, 0, 0], [0.1, 0.04, 0.02]], scan_cfg, noise=0.002, seed=3
    )
    src = np.asarray(pts[1]).copy()
    n = src.shape[0]
    k = int(0.15 * n)
    # a contiguous angular block (an object crossing the field of view),
    # displaced far enough that untrimmed correspondences would drag the fit
    src[40:40 + k] = src[40:40 + k] * 0.4 + np.array([0.8, -0.5])
    res = plicp_match(
        jnp.asarray(src, jnp.float32), valid[1], pts[0], valid[0], pcfg
    )
    pose = np.asarray(res.pose)
    assert np.allclose(pose[:2], [0.1, 0.04], atol=0.02), pose
    assert abs(pose[2] - 0.02) < 0.01, pose


def test_corridor_odometry_failure_mode_matches_reference():
    """Full odometry down a long corridor: the reference documents PL-ICP
    drifting along the corridor (README.md:100). Our odometry must fail the
    SAME way — along-axis drift — while lateral/heading error stays tiny
    (a different failure shape would indicate a real semantic deviation)."""
    from tpu_slam.models.plicp_odometry import PLICPOdometry

    scan_cfg, _ = _cfg()
    cfg = dataclasses.replace(default_config(), scan=scan_cfg)
    world = corridor_world(length=60.0)
    T = 60
    gt = np.stack(
        [0.09 * np.arange(T), np.zeros(T), np.zeros(T)], axis=-1
    )
    seq = sim.simulate_sequence(world, gt, cfg.scan, noise_std=0.003, seed=5)
    scans = make_scan(seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32))
    odo = PLICPOdometry(cfg)
    est = odo.run(scans)
    lateral = np.abs(np.asarray(est)[:, 1])
    heading = np.abs(np.asarray(est)[:, 2])
    assert lateral.max() < 0.05, lateral.max()
    assert heading.max() < 0.02, heading.max()
