"""Auxiliary subsystems: rosbag IO, checkpoint/resume, events, profiling."""

import dataclasses
import os

import numpy as np
import pytest

from tpu_slam.config import ScanConfig, default_config
from tpu_slam.data import rosbag, simulator as sim
from tpu_slam.data.scan import make_scan
from tpu_slam.utils.events import Event, EventBus
from tpu_slam.utils.profiling import StageTimer, ThroughputCounter


def test_rosbag_roundtrip(tmp_path):
    cfg = ScanConfig(num_beams=90)
    world = sim.office_world(seed=3)
    traj = sim.circle_trajectory(5, radius=1.5)
    seq = sim.simulate_sequence(world, traj, cfg, seed=1)
    msgs = []
    for t in range(5):
        raw = rosbag.serialize_laser_scan(
            {
                "stamp": float(seq.stamps[t]),
                "frame_id": "front_laser_link",
                "angle_min": cfg.angle_min,
                "angle_max": cfg.angle_min + cfg.angle_increment * 89,
                "angle_increment": cfg.angle_increment,
                "time_increment": cfg.scan_period / 90,
                "scan_time": cfg.scan_period,
                "range_min": cfg.range_min,
                "range_max": cfg.range_max,
                "ranges": seq.ranges[t],
                "intensities": np.zeros(90),
            }
        )
        msgs.append(("laser_scan", "sensor_msgs/LaserScan", float(seq.stamps[t]), raw))
    path = str(tmp_path / "test.bag")
    rosbag.write_bag(path, msgs)

    out = list(rosbag.parse_messages(path))
    assert len(out) == 5
    msg, parsed = out[2]
    assert msg.topic == "laser_scan"
    assert parsed["frame_id"] == "front_laser_link"
    np.testing.assert_allclose(
        parsed["ranges"], seq.ranges[2], rtol=1e-6
    )
    np.testing.assert_allclose(parsed["stamp"], seq.stamps[2], atol=1e-6)
    # topic filter
    assert list(rosbag.parse_messages(path, topics={"other"})) == []


def test_rosbag_rejects_non_bag(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"not a bag")
    with pytest.raises(ValueError):
        list(rosbag.read_bag(str(p)))


@pytest.mark.slow
def test_karto_checkpoint_roundtrip(tmp_path):
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_karto import small_karto_cfg, drifted_odometry
    from tpu_slam.models.karto.pipeline import KartoSLAM
    from tpu_slam.utils.checkpoint import load_karto, save_karto

    cfg = small_karto_cfg()
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:120]
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=8)
    odom = drifted_odometry(seq.gt_poses, seed=3)
    scans = make_scan(seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32))

    slam = KartoSLAM(cfg)
    slam.run(scans, odom)
    n_scans = len(slam.scans)
    n_edges = slam.solver.num_edges
    path = str(tmp_path / "karto.npz")
    save_karto(slam, path)

    slam2 = KartoSLAM(cfg)
    load_karto(slam2, path)
    assert len(slam2.scans) == n_scans
    assert slam2.solver.num_edges == n_edges
    assert list(slam2.running) == list(slam.running)
    np.testing.assert_allclose(slam2.trajectory(), slam.trajectory())

    # resume: process remaining scans on the restored instance
    from tpu_slam.data.scan import index_scan

    more = sim.simulate_sequence(
        world, traj[-10:], cfg.scan, noise_std=0.004, seed=9
    )
    # (same last pose region; just check processing continues cleanly)
    scans2 = make_scan(more.ranges, cfg.scan)
    before = len(slam2.scans)
    for t in range(10):
        slam2.process(index_scan(scans2, t), odom[-10 + t])
    assert np.isfinite(slam2.trajectory()).all()


def test_hector_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    from tpu_slam.models.hector_slam import HectorSLAM
    from tpu_slam.utils.checkpoint import load_hector, save_hector

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg, hector=dataclasses.replace(cfg.hector, map_size=128,
                                        map_multi_res_levels=2)
    )
    world = sim.office_world(seed=2)
    traj = sim.circle_trajectory(5, radius=1.2)
    seq = sim.simulate_sequence(world, traj, cfg.scan, seed=0)
    scans = make_scan(seq.ranges, cfg.scan)
    slam = HectorSLAM(cfg)
    slam.run(scans)
    path = str(tmp_path / "hector.npz")
    save_hector(slam, path)

    slam2 = HectorSLAM(cfg)
    load_hector(slam2, path)
    for g1, g2 in zip(slam.grids, slam2.grids):
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g2))
    np.testing.assert_allclose(
        np.asarray(slam.last_pose), np.asarray(slam2.last_pose)
    )


def test_event_bus():
    bus = EventBus()
    got = []
    bus.add_listener(got.append)
    bus.loop_closure_check("checking")
    bus.begin_loop_closure("begin")
    bus.end_loop_closure("end")
    assert [e.kind for e in got] == [
        "loop_closure_check", "begin_loop_closure", "end_loop_closure",
    ]
    assert len(bus.history) == 3
    bus.remove_listener(got.append)
    bus.info("quiet")
    assert len(got) == 3 and len(bus.history) == 4


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    assert t.counts["a"] == 2
    assert "a:" in t.report()
    c = ThroughputCounter()
    c.tick(10)
    assert c.per_sec > 0


def test_karto_occupancy_map():
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_karto import small_karto_cfg, drifted_odometry
    from tpu_slam.models.karto.pipeline import KartoSLAM
    from tpu_slam.models.karto.occupancy import karto_map

    cfg = small_karto_cfg()
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:100]
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=8)
    odom = drifted_odometry(seq.gt_poses, seed=3)
    scans = make_scan(seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32))
    slam = KartoSLAM(cfg)
    slam.run(scans, odom)
    m, gcfg = karto_map(slam, resolution=0.1)
    assert (m == 100).sum() > 100
    assert (m == 0).sum() > 1000
    assert (m == -1).sum() > 100
    # events were fired during the run (at least loop closure checks)
    kinds = {e.kind for e in slam.events.history}
    assert "loop_closure_check" in kinds or slam.loop_closures == 0


def test_config_from_yaml(tmp_path):
    from tpu_slam.config import config_from_yaml

    p = tmp_path / "params.yaml"
    p.write_text(
        "plicp:\n  max_iterations: 5\n  sigma: 0.02\n"
        "karto:\n  minimum_travel_distance: 0.5\n"
        "hector:\n  map_size: 256\n"
    )
    cfg = config_from_yaml(str(p))
    assert cfg.plicp.max_iterations == 5
    assert cfg.plicp.sigma == 0.02
    assert cfg.karto.minimum_travel_distance == 0.5
    assert cfg.hector.map_size == 256
    # untouched defaults preserved
    assert cfg.plicp.max_correspondence_dist == 1.0


def test_karto_map_to_odom():
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_karto import small_karto_cfg
    from tpu_slam.models.karto.pipeline import KartoSLAM
    from tpu_slam.data.scan import make_scan, index_scan
    import jax.numpy as jnp
    from tpu_slam import geometry as geo

    cfg = small_karto_cfg()
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:5]
    seq = sim.simulate_sequence(world, traj, cfg.scan, seed=1)
    scans = make_scan(seq.ranges, cfg.scan)
    slam = KartoSLAM(cfg)
    slam.process(index_scan(scans, 0), seq.gt_poses[0])
    m2o = slam.map_to_odom()
    # map_to_odom ∘ odom == corrected
    got = np.asarray(
        geo.compose(jnp.asarray(m2o), jnp.asarray(seq.gt_poses[0]))
    )
    np.testing.assert_allclose(
        got, slam.scans[0].corrected_pose, atol=1e-5
    )


def test_map_io_roundtrip(tmp_path):
    """save_map/load_map must round-trip the trinary map and grid metadata
    in ROS map_server's PGM+YAML format."""
    from tpu_slam.config import GridConfig
    from tpu_slam.utils.map_io import load_map, save_map

    rng = np.random.RandomState(3)
    m = rng.choice(
        np.array([-1, 0, 100], np.int8), size=(37, 53)
    ).astype(np.int8)
    grid = GridConfig(
        resolution=0.05, size_x=53, size_y=37, origin_x=-1.25, origin_y=2.5
    )
    pgm, yml = save_map(str(tmp_path / "map"), m, grid)
    m2, g2 = load_map(yml)
    np.testing.assert_array_equal(m2, m)
    assert g2.resolution == grid.resolution
    assert (g2.origin_x, g2.origin_y) == (grid.origin_x, grid.origin_y)
    assert (g2.size_x, g2.size_y) == (53, 37)
    # the PGM itself is a valid binary P5 with map_saver's palette
    with open(pgm, "rb") as f:
        assert f.read(2) == b"P5"


def test_cli_smoke(tmp_path):
    """python -m tpu_slam: the launch-file replacement runs a pipeline from
    the simulator and writes a map_server-compatible map."""
    from tpu_slam.cli import main

    out = str(tmp_path / "m")
    rc = main([
        "karto", "--sim", "--sim-scans", "20", "--save-map", out,
    ])
    assert rc == 0
    import os

    assert os.path.exists(out + ".pgm") and os.path.exists(out + ".yaml")
    # karto runs also export the pose-graph visualization
    assert os.path.exists(out + "_graph.png")
    assert main(["odometry", "--sim", "--sim-scans", "10"]) == 0


def _decode_png(path):
    """Minimal PNG decode for save_png's output (8-bit RGB, filter 0)."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    i, idat = 8, b""
    w = h = None
    while i < len(data):
        (ln,) = struct.unpack(">I", data[i : i + 4])
        tag = data[i + 4 : i + 8]
        body = data[i + 8 : i + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            assert (depth, ctype) == (8, 2)
        elif tag == b"IDAT":
            idat += body
        i += 12 + ln
    raw = zlib.decompress(idat)
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + w * 3)
    assert (rows[:, 0] == 0).all()  # filter type 0 per scanline
    return rows[:, 1:].reshape(h, w, 3)


def test_graph_png_renders_typed_edges(tmp_path):
    """save_graph_png draws nodes and sequential/chain/loop edges in their
    palette colors at the correct map cells (the publishGraphVisualization
    artifact, karto_slam.cc:603-682)."""
    from tpu_slam.config import GridConfig
    from tpu_slam.utils.map_io import GRAPH_COLORS, save_graph_png

    grid = GridConfig(
        resolution=0.1, size_x=40, size_y=30, origin_x=0.0, origin_y=0.0
    )
    m = np.zeros((30, 40), np.int8)  # all free
    poses = np.array(
        [[0.5, 0.5, 0.0], [2.5, 0.5, 0.0], [2.5, 2.5, 0.0], [0.5, 2.5, 0.0]]
    )
    edges = [
        (0, 1, "sequential"), (1, 2, "sequential"), (2, 3, "chain"),
        (3, 0, "loop"),
    ]
    path = save_graph_png(str(tmp_path / "g.png"), m, grid, poses, edges)
    rgb = _decode_png(path)[::-1]  # back to south-edge-first rows
    assert rgb.shape == (30, 40, 3)
    # midpoint of each edge carries that edge's color; nodes their own
    assert tuple(rgb[5, 15]) == GRAPH_COLORS["sequential"]  # (1.5, 0.5)
    assert tuple(rgb[15, 25]) == GRAPH_COLORS["sequential"]  # (2.5, 1.5)
    assert tuple(rgb[25, 15]) == GRAPH_COLORS["chain"]  # (1.5, 2.5)
    assert tuple(rgb[15, 5]) == GRAPH_COLORS["loop"]  # (0.5, 1.5)
    assert tuple(rgb[5, 6]) == GRAPH_COLORS["node"]  # next to pose 0
    # background stays the trinary free color
    assert tuple(rgb[2, 35]) == (254, 254, 254)


def test_karto_records_edge_kinds():
    """KartoSLAM.graph_edges stays in lockstep with the solver's constraint
    list and tags every edge with a renderable kind."""
    import dataclasses

    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.models.karto.pipeline import KartoSLAM

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(
            cfg.scan, num_beams=90, angle_increment=2 * np.pi / 90,
            range_max=6.0, range_threshold=5.0,
        ),
        correlative=dataclasses.replace(
            cfg.correlative, correlation_search_space_resolution=0.02
        ),
    )
    world = sim.office_world(seed=3, size=8.0)
    traj = sim.circle_trajectory(30, radius=1.5)
    seq = sim.simulate_sequence(world, traj, cfg.scan, seed=4)
    scans = make_scan(seq.ranges, cfg.scan)
    slam = KartoSLAM(cfg)
    slam.run(scans, seq.gt_poses)
    assert len(slam.graph_edges) == slam.solver.num_edges
    kinds = {k for _, _, k in slam.graph_edges}
    assert kinds <= {"sequential", "chain", "loop"}
    assert "sequential" in kinds


def test_config_presets_match_reference_yaml():
    """The shipped presets mirror the reference's two mapper parameter
    files (lesson6/config/mapper_params.yaml / mapper_params_outdoor.yaml):
    spot-check the values that differ between them."""
    from tpu_slam.config import preset

    indoor = preset("karto_indoor")
    outdoor = preset("karto_outdoor")
    assert indoor.scan.range_threshold == 12.0  # use_scan_range
    assert outdoor.scan.range_threshold == 50.0
    assert indoor.correlative.correlation_search_space_resolution == 0.01
    assert outdoor.correlative.correlation_search_space_resolution == 0.05
    assert indoor.loop.loop_search_space_dimension == 10.0
    assert outdoor.loop.loop_search_space_dimension == 15.0
    assert outdoor.loop.loop_search_space_smear_deviation == 0.3
    assert outdoor.karto.scan_buffer_size == 110
    assert outdoor.karto.scan_buffer_maximum_scan_distance == 50.0
    # squared-raw penalty mapping (Mapper.cpp:1919-1927)
    assert indoor.correlative.distance_variance_penalty == 0.5**2
    assert outdoor.correlative.distance_variance_penalty == 0.3**2
    import pytest

    with pytest.raises(ValueError):
        preset("nope")


def test_preset_loads_without_pyyaml(monkeypatch):
    """Shipped presets are TOML, read by the standard library: they must
    load on a machine without PyYAML."""
    import sys

    from tpu_slam.config import config_from_yaml, preset

    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = preset("karto_outdoor")
    assert cfg.scan.range_threshold == 50.0
    assert cfg.offline.seeds_xy == 5
    with pytest.raises(ImportError, match="PyYAML"):
        config_from_yaml("params.yaml")


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_directory(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set;
    without it the cache is one fixed, git-ignored directory in the
    checkout."""
    import jax

    from tpu_slam.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    min_s = jax.config.jax_persistent_cache_min_compile_time_secs
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(repo, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    try:
        assert compile_cache.enable() == want
        if env_dir is None:
            assert jax.config.jax_compilation_cache_dir == want
        else:  # JAX reads the variable itself; enable() sets nothing
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_s)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_scan_is_a_pytree_with_replace():
    """Scan is a frozen dataclass registered with JAX (no flax): it maps,
    jits and replaces fields."""
    import jax

    scans = make_scan(np.ones((2, 8), np.float32) * 2.0, ScanConfig(
        num_beams=8))
    leaves = jax.tree_util.tree_leaves(scans)
    assert len(leaves) == 5
    doubled = jax.jit(lambda s: s.replace(ranges=2 * s.ranges))(scans)
    np.testing.assert_array_equal(np.asarray(doubled.ranges), 4.0)
    np.testing.assert_array_equal(
        np.asarray(doubled.valid), np.asarray(scans.valid))
    with pytest.raises(dataclasses.FrozenInstanceError):
        scans.ranges = None


def test_load_map_without_pyyaml_names_the_package(monkeypatch, tmp_path):
    import sys

    from tpu_slam.utils.map_io import load_map

    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        load_map(str(tmp_path / "map.yaml"))
