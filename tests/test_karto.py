import dataclasses
import math

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_slam import geometry as geo
from tpu_slam.config import default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan
from tpu_slam.models.karto.pipeline import KartoSLAM
from tpu_slam.utils.evaluation import ate_rmse


def small_karto_cfg():
    cfg = default_config()
    # shrink grids for CPU test speed: coarser correlation grid + shorter range
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(
            cfg.scan, num_beams=180, range_max=6.0, range_threshold=5.0
        ),
        correlative=dataclasses.replace(
            cfg.correlative,
            correlation_search_space_resolution=0.02,
        ),
        loop=dataclasses.replace(
            cfg.loop,
            loop_search_space_dimension=4.0,
            loop_search_maximum_distance=3.0,
            loop_match_minimum_chain_size=5,
        ),
    )
    return cfg


def drifted_odometry(gt, seed=0, trans_sigma=0.02, rot_sigma=0.004):
    """Integrate gt relative motions with noise → drifting wheel odometry."""
    rng = np.random.default_rng(seed)
    odom = [gt[0].copy()]
    for i in range(1, len(gt)):
        d = np.array(
            geo.relative(jnp.asarray(gt[i - 1]), jnp.asarray(gt[i]))
        )
        d[:2] += rng.normal(0, trans_sigma, 2)
        d[2] += rng.normal(0, rot_sigma)
        odom.append(
            np.asarray(geo.compose(jnp.asarray(odom[-1]), jnp.asarray(d)))
        )
    return np.asarray(odom)


@pytest.fixture(scope="module")
def loop_setup():
    cfg = small_karto_cfg()
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=8)
    odom = drifted_odometry(seq.gt_poses, seed=3)
    scans = make_scan(seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32))
    return cfg, scans, seq, odom


@pytest.mark.slow
def test_karto_front_end_tracks(loop_setup):
    """Scan matching alone (loop closing off) keeps ATE below raw odometry."""
    cfg, scans, seq, odom = loop_setup
    cfg2 = dataclasses.replace(
        cfg, karto=dataclasses.replace(cfg.karto, do_loop_closing=False)
    )
    slam = KartoSLAM(cfg2)
    accepted = slam.run(scans, odom)
    assert len(accepted) > 30  # HasMovedEnough decimates ~10Hz scans
    est = slam.trajectory()
    gt = seq.gt_poses[accepted]
    ate = ate_rmse(est, gt)
    ate_odom = ate_rmse(odom[accepted], gt)
    # measured 0.076 m vs 0.249 m odometry (gates sized
    # at ~2x the measured value so a 3x matcher regression FAILS)
    assert ate < ate_odom * 0.55, (ate, ate_odom)
    assert ate < 0.15, ate


@pytest.mark.slow
def test_karto_loop_closure_improves(loop_setup):
    cfg, scans, seq, odom = loop_setup
    slam = KartoSLAM(cfg)
    accepted = slam.run(scans, odom)
    est = slam.trajectory()
    gt = seq.gt_poses[accepted]
    ate = ate_rmse(est, gt)
    assert slam.loop_closures >= 1, "no loop closures found"
    # measured 0.023-0.029 m; 2x margin
    assert ate < 0.06, ate


@pytest.mark.slow
def test_karto_multi_sensor_loop_closure(loop_setup):
    """TryCloseLoop runs against EVERY registered sensor's scan list
    (Mapper.cpp:2064-2069): with two identical lasers fed alternately
    around the corridor loop, each sensor's candidate chains are half as
    dense, but cross-sensor closures must still trigger and correct the
    drift."""
    import jax

    from tpu_slam.models.karto.pipeline import LaserRig

    cfg, scans, seq, odom = loop_setup
    slam = KartoSLAM(cfg)
    slam.register_laser("laser1", LaserRig())
    scans_np = jax.tree_util.tree_map(np.asarray, scans)
    from tpu_slam.data.scan import index_scan

    accepted = []
    for t in range(scans_np.ranges.shape[0]):
        name = "laser0" if t % 2 == 0 else "laser1"
        if slam.process(index_scan(scans_np, t), odom[t], sensor=name):
            accepted.append(t)
    slam.flush()
    assert slam.loop_closures >= 1, "no loop closures across sensors"
    est = slam.trajectory()
    gt = seq.gt_poses[accepted]
    ate = ate_rmse(est, gt)
    assert ate < 0.2, ate
    # both sensors contributed scans
    assert len(slam.sensors["laser0"].scan_ids) > 20
    assert len(slam.sensors["laser1"].scan_ids) > 20


@pytest.mark.slow
def test_karto_async_loop_closure_matches_sync(loop_setup):
    """Pipeline-parallel back-end: corrections dispatched asynchronously and
    propagated chain-consistently must land within a few cm of the inline
    (reference-semantics) solve."""
    cfg, scans, seq, odom = loop_setup
    cfg2 = dataclasses.replace(
        cfg, karto=dataclasses.replace(cfg.karto, async_loop_closure=True)
    )
    slam = KartoSLAM(cfg2)
    accepted = slam.run(scans, odom)
    est = slam.trajectory()
    gt = seq.gt_poses[accepted]
    ate = ate_rmse(est, gt)
    assert slam.loop_closures >= 1, "no loop closures found"
    assert ate < 0.2, ate


def test_karto_rejects_stationary(loop_setup):
    cfg, scans, seq, odom = loop_setup
    slam = KartoSLAM(cfg)
    from tpu_slam.data.scan import index_scan

    s0 = index_scan(scans, 0)
    assert slam.process(s0, odom[0])
    # same pose again → HasMovedEnough gate rejects
    assert not slam.process(s0, odom[0])
    assert len(slam.scans) == 1


def test_karto_minimum_time_interval_accepts_stationary(loop_setup):
    """MinimumTimeInterval (Mapper.cpp:2095-2099): a stationary scan is
    accepted once enough time has passed since the last processed scan."""
    cfg, scans, seq, odom = loop_setup
    cfg2 = dataclasses.replace(
        cfg, karto=dataclasses.replace(cfg.karto, minimum_time_interval=5.0)
    )
    slam = KartoSLAM(cfg2)
    from tpu_slam.data.scan import index_scan

    s0 = index_scan(scans, 0)

    def at(t):
        return dataclasses.replace(s0, stamp=jnp.asarray(float(t)))

    assert slam.process(at(0.0), odom[0])
    assert not slam.process(at(1.0), odom[0])  # too soon, no travel
    assert slam.process(at(6.0), odom[0])  # time gate fires
    assert len(slam.scans) == 2


def test_laser_rig_upside_down_detection():
    """from_mount reproduces the reference's +1 m-point test
    (karto_slam.cc:359-380)."""
    from tpu_slam.models.karto.pipeline import LaserRig

    assert not LaserRig.from_mount(0.2, 0.0, 0.1, 0.0, 0.0, 0.5).inverted
    assert LaserRig.from_mount(0.2, 0.0, 0.1, math.pi, 0.0, 0.5).inverted
    assert LaserRig.from_mount(0.0, 0.0, 0.0, 0.0, math.pi, 0.0).inverted
    rig = LaserRig.from_mount(0.2, -0.1, 0.1, 0.0, 0.0, 0.5)
    assert rig.offset == (0.2, -0.1, 0.5)
    assert LaserRig().is_identity and not rig.is_identity


@pytest.mark.slow
def test_karto_multi_sensor_shared_graph(loop_setup):
    """Two registered lasers (MapperSensorManager, Mapper.h:1288-1404):
    per-sensor running buffers / previous-scan links / HasMovedEnough, one
    shared pose graph. A front laser and a yaw-rotated second laser fed
    alternately must each keep a per-sensor scan list, both must contribute
    graph nodes, and the combined base trajectory must track ground truth."""
    import jax

    from tpu_slam.models.karto.pipeline import LaserRig

    cfg, scans, seq, odom = loop_setup
    n = 60
    sub = jax.tree_util.tree_map(lambda a: a[:n], scans)
    ranges = np.asarray(sub.ranges)
    valid = np.asarray(sub.valid)
    stamps = np.asarray(sub.stamp)

    slam = KartoSLAM(cfg)  # laser0 = identity rig
    yaw = 0.25
    slam.register_laser("laser1", LaserRig(offset=(0.0, 0.0, yaw)))

    gt = seq.gt_poses[:n]
    accepted = {"laser0": [], "laser1": []}
    for t in range(n):
        name = "laser0" if t % 2 == 0 else "laser1"
        sc = make_scan(
            ranges[t][None], cfg.scan, stamp=stamps[t][None]
        )
        sc = jax.tree_util.tree_map(lambda a: a[0], sc)
        if name == "laser1":
            # a laser yawed by +yaw sees the same world rotated by -yaw:
            # shift the beam array so beam angles stay aligned
            shift = int(round(yaw / float(sc.angles[1] - sc.angles[0])))
            sc = dataclasses.replace(
                sc,
                ranges=jnp.roll(sc.ranges, -shift),
                valid=jnp.roll(sc.valid, -shift),
            )
        if slam.process(sc, odom[t], sensor=name):
            accepted[name].append(t)

    # per-sensor scan lists are disjoint and cover all scans
    ids0 = slam.sensors["laser0"].scan_ids
    ids1 = slam.sensors["laser1"].scan_ids
    assert len(ids0) > 10 and len(ids1) > 10
    assert set(ids0).isdisjoint(ids1)
    assert len(ids0) + len(ids1) == len(slam.scans)
    # per-sensor seq numbering is contiguous
    assert [slam.scans[i].seq for i in ids0] == list(range(len(ids0)))
    assert [slam.scans[i].seq for i in ids1] == list(range(len(ids1)))
    # both sensors' chains feed ONE graph: some edge connects the sensors
    cross = any(
        slam.scans[i].sensor != slam.scans[j].sensor
        for i, nbrs in slam.adjacency.items()
        for j in nbrs
    )
    assert cross, "no cross-sensor edges in the shared graph"

    # combined base trajectory tracks ground truth (scans are stored in
    # acceptance order == time order, matching sorted accepted timesteps)
    order_t = sorted(accepted["laser0"] + accepted["laser1"])
    est = slam.trajectory()
    assert ate_rmse(est, gt[order_t]) < 0.15


@pytest.mark.slow
def test_karto_laser_rig_offset_equivariance(loop_setup):
    """Feeding BASE odometry with a registered laser offset (and an
    upside-down laser whose readings arrive reversed) must reproduce the
    identity-rig trajectory expressed in the base frame."""
    from tpu_slam.models.karto.pipeline import LaserRig

    import jax

    cfg, scans, seq, odom = loop_setup
    n = 60  # prefix is enough; keep CPU time bounded
    sub = jax.tree_util.tree_map(lambda a: a[:n], scans)
    plain = KartoSLAM(cfg)
    plain.run(sub, odom[:n])
    ref_traj = plain.trajectory()

    off = np.array([0.2, -0.1, 0.3])
    rig = LaserRig(offset=tuple(off), inverted=True)
    inv_off = np.asarray(geo.inverse(jnp.asarray(off)), np.float64)
    base_odom = np.asarray(
        [geo.compose(jnp.asarray(p), jnp.asarray(inv_off)) for p in odom[:n]]
    )
    # an upside-down laser reports its readings in reverse beam order
    sub_inv = dataclasses.replace(
        sub,
        ranges=jnp.asarray(np.asarray(sub.ranges)[:, ::-1]),
        valid=jnp.asarray(np.asarray(sub.valid)[:, ::-1]),
    )
    rigged = KartoSLAM(cfg, laser=rig)
    rigged.run(sub_inv, base_odom)
    got = rigged.trajectory()  # base poses

    want = np.asarray(
        [geo.compose(jnp.asarray(p), jnp.asarray(inv_off)) for p in ref_traj]
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-2)

    # karto_map must rasterize from SENSOR poses (laser-frame points +
    # corrected sensor pose), so the rigged map ≈ the identity-rig map
    from tpu_slam.models.karto.occupancy import karto_map

    m_plain, g_plain = karto_map(plain, resolution=0.1)
    m_rig, g_rig = karto_map(rigged, resolution=0.1)
    occ_plain = np.argwhere(m_plain == 100)
    occ_rig = np.argwhere(m_rig == 100)
    # compare occupied cells in WORLD coords (grids auto-bound separately)
    w_plain = occ_plain[:, ::-1] * g_plain.resolution + [
        g_plain.origin_x, g_plain.origin_y
    ]
    w_rig = occ_rig[:, ::-1] * g_rig.resolution + [
        g_rig.origin_x, g_rig.origin_y
    ]
    assert len(w_rig) > 0.5 * len(w_plain)
    d = np.sqrt(
        ((w_rig[:, None, :] - w_plain[None, :, :]) ** 2).sum(-1)
    ).min(axis=1)
    # every rigged occupied cell has a plain occupied cell within 2 cells
    assert np.quantile(d, 0.95) <= 2 * g_plain.resolution + 1e-9


@pytest.mark.slow
def test_device_scan_store_path_matches_data_path(loop_setup):
    """The index-addressed device-store match (match_chains_store) must be
    bit-identical to the data-carrying match on the same chains."""
    import jax

    cfg, scans, seq, odom = loop_setup
    slam = KartoSLAM(cfg)
    sub = jax.tree_util.tree_map(lambda a: a[:40], scans)
    slam.run(sub, odom[:40])
    st = slam.sensors["laser0"]
    assert st.last_scan_id is not None
    rec = slam.scans[st.last_scan_id]
    chains = [st.scan_ids[:-1], st.scan_ids[: len(st.scan_ids) // 2]]
    center = np.asarray(rec.corrected_pose, np.float32)

    poses, pts, valid, lv = slam._chain_batch_inputs(chains)
    a = slam.front_matcher.match_chains(
        poses, pts, valid, rec.pts_laser, rec.beam_valid, center,
        lane_valid=lv,
    )
    store = slam._stores[rec.pts_laser.shape[0]]
    poses2, idx, lv2 = slam._chain_batch_indices(chains)
    np.testing.assert_array_equal(poses, poses2)
    b = slam.front_matcher.match_chains_store(
        store.pts, store.valid, idx, poses2, rec.pts_laser,
        rec.beam_valid, center, lane_valid=lv2,
    )
    np.testing.assert_array_equal(np.asarray(a.pose), np.asarray(b.pose))
    np.testing.assert_array_equal(
        np.asarray(a.response), np.asarray(b.response)
    )
    np.testing.assert_array_equal(
        np.asarray(a.covariance), np.asarray(b.covariance)
    )


def test_device_scan_store_growth():
    """DeviceScanStore capacity quadrupling preserves every stored row."""
    from tpu_slam.models.karto.pipeline import DeviceScanStore

    st = DeviceScanStore(64, init_cap=8)
    rows = []
    for i in range(40):  # forces two growths (8 → 32 → 128)
        pts = np.full((64, 2), float(i), np.float32)
        valid = (np.arange(64) % (i + 1)) == 0
        rows.append((st.append(pts, valid), pts, valid))
    assert st.pts.shape[0] == 128 and st.count == 40
    for r, pts, valid in rows:
        np.testing.assert_array_equal(np.asarray(st.pts[r]), pts)
        np.testing.assert_array_equal(np.asarray(st.valid[r]), valid)


@pytest.mark.slow
def test_karto_mesh_pipeline_matches_single_device(loop_setup):
    """KartoSLAM(cfg, mesh=...) — edge-sharded psum LM back-end + ring-pass
    loop-candidate search over the 8-device mesh — must reproduce the
    single-device mission: same accepted scans, same loop closures, same
    trajectory (distributed primitives wired into the
    flagship pipeline, not standalone)."""
    from tpu_slam.parallel.mesh import make_mesh

    cfg, scans, seq, odom = loop_setup
    ref = KartoSLAM(cfg)
    acc_ref = ref.run(scans, odom)
    slam = KartoSLAM(cfg, mesh=make_mesh())
    acc = slam.run(scans, odom)
    assert list(acc) == list(acc_ref)
    assert slam.loop_closures == ref.loop_closures
    est, est_ref = slam.trajectory(), ref.trajectory()
    np.testing.assert_allclose(est, est_ref, atol=5e-3)
