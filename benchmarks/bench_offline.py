"""Offline batch SLAM throughput: the 3-lap corridor mission in a handful
of batched device programs.

Same mission as bench_karto_soak.py (984 scans, drifting odometry, repeated
loop closures) so the two process models compare directly: the ONLINE
pipeline pays per-scan dispatches, the OFFLINE pipeline matches every
consecutive pair in one batched PL-ICP call, brute-forces loop basins
with a seed lattice in one more, and solves the graph on device.

    python benchmarks/bench_offline.py --laps 3
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--laps", type=int, default=3)
    ap.add_argument("--map", action="store_true", help="also build the map")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from tpu_slam.utils.compile_cache import enable

        enable()  # persistent XLA compilation cache

    import jax.numpy as jnp

    from tpu_slam import geometry as geo
    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.models.offline import offline_slam
    from tpu_slam.utils.evaluation import ate_rmse

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(
            cfg.scan, num_beams=180, range_max=6.0, range_threshold=5.0
        ),
    )

    arm, width = 9.0, 2.6
    m = (arm / 2 + (arm / 2 - width)) / 2
    lap = [[m, -m], [m, m], [-m, m], [-m, -m]]
    wps = np.array([[-m, -m]] + lap * args.laps + [[0.0, -m]])
    traj = sim.waypoint_trajectory(wps, speed=0.9, dt=0.1)
    world = sim.corridor_loop_world(arm=arm, width=width)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=8)

    rng = np.random.default_rng(3)
    odom = [seq.gt_poses[0].copy()]
    for i in range(1, len(seq.gt_poses)):
        d = np.array(
            geo.relative(
                jnp.asarray(seq.gt_poses[i - 1]), jnp.asarray(seq.gt_poses[i])
            )
        )
        d[:2] += rng.normal(0, 0.02, 2)
        d[2] += rng.normal(0, 0.004)
        odom.append(
            np.asarray(geo.compose(jnp.asarray(odom[-1]), jnp.asarray(d)))
        )
    odom = np.asarray(odom)
    scans = make_scan(seq.ranges, cfg.scan)
    T = len(traj)

    # warm run (compiles), then the timed run
    res = offline_slam(scans, cfg, odom=odom)
    t0 = time.perf_counter()
    res = offline_slam(scans, cfg, odom=odom)
    wall = time.perf_counter() - t0

    ate_chain = ate_rmse(res.chain_poses, seq.gt_poses)
    ate_opt = ate_rmse(res.poses, seq.gt_poses)
    ate_odom = ate_rmse(odom, seq.gt_poses)
    print(
        f"laps={args.laps} scans={T} wall={wall:.2f}s"
        f" ({1e3 * wall / T:.1f} ms/scan, {T / wall:.0f} scans/s)"
        f" loops={len(res.loops)} tried={res.candidates_tried}",
        file=sys.stderr,
    )
    print(
        f"ATE odom={ate_odom:.4f} chain={ate_chain:.4f} slam={ate_opt:.4f} m",
        file=sys.stderr,
    )
    print(
        "stage timing:\n  " + res.timer.report().replace("\n", "\n  "),
        file=sys.stderr,
    )

    map_s = float("nan")
    if args.map:
        from tpu_slam.models.karto.occupancy import (
            compute_grid_bounds, occupancy_from_scans,
        )

        with np.errstate(invalid="ignore"):
            pts = np.asarray(scans.points()).astype(np.float32)
        pts[~np.isfinite(pts)] = 0.0
        t0 = time.perf_counter()
        gcfg = compute_grid_bounds(res.poses, cfg.scan.range_threshold, 0.05)
        grid = occupancy_from_scans(
            gcfg, res.poses, pts, np.asarray(scans.ranges),
            cfg.scan.range_threshold,
            min_range=cfg.scan.range_min, max_range=cfg.scan.range_max,
        )
        map_s = time.perf_counter() - t0
        print(
            f"map {grid.shape}: {(grid == 100).sum()} occ"
            f" / {(grid == 0).sum()} free in {map_s:.2f}s", file=sys.stderr,
        )

    print(
        f"offline_wall_s={wall:.2f} offline_scans_per_s={T / wall:.0f} "
        f"ate_slam_m={ate_opt:.4f} loops={len(res.loops)} map_s={map_s:.2f}"
    )


if __name__ == "__main__":
    main()
