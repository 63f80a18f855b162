"""Outdoor-scale Karto mission.

The reference ships a dedicated outdoor configuration
(`lesson6/config/mapper_params_outdoor.yaml`: 50 m scan range,
scan_buffer_size 110 / 50 m span, 15 m loop search grid at 0.1 m,
minimum_time_interval 3600) for the lesson6-rslidar-outdoor-gps bag.
This benchmark runs that configuration end-to-end on a simulated
outdoor city-block loop (streets ~16 m wide, building walls + street
clutter, multi-kilometer trajectory, ≥5k scans), both offline (batched
whole-mission pipeline) and online (scan-at-a-time KartoSLAM).

    python benchmarks/bench_outdoor.py --laps 2            # offline, GPU
    python benchmarks/bench_outdoor.py --online --laps 1
    python benchmarks/bench_outdoor.py --cpu --laps 1 --scans 600  # smoke
"""

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def outdoor_cfg(async_backend=False):
    """The shipped karto_outdoor preset (mapper_params_outdoor.yaml
    parity, tpu_slam/configs/karto_outdoor.yaml).

    async_backend=True overlaps back-end solves with scan processing
    (pipeline parallelism) — measured trade on the 1-lap mission: wall
    137 → 95 s but ATE 0.024 → 0.14-0.23 m, because matches issued
    between a solve dispatch and its harvest run from stale poses and
    bake that bias into their edges. The default is the reference's
    synchronous CorrectPoses semantics (accuracy first)."""
    from tpu_slam.config import preset

    cfg = preset("karto_outdoor")
    return dataclasses.replace(
        cfg,
        karto=dataclasses.replace(
            cfg.karto, async_loop_closure=async_backend
        ),
    )


def outdoor_world(arm=80.0, street=16.0, seed=0):
    """City block: outer walls, inner building block, street clutter
    (parked boxes near the walls — the outdoor bag's parked cars)."""
    from tpu_slam.data import simulator as sim

    w = sim.corridor_loop_world(arm=arm, width=street)
    h, wi = arm / 2, arm / 2 - street
    rng = np.random.default_rng(seed)
    for _ in range(60):
        side = rng.integers(4)
        along = rng.uniform(-h + 2, h - 2)
        off = rng.uniform(0.6, 2.2)  # distance from a wall
        near_outer = rng.random() < 0.5
        d = (h - off) if near_outer else (wi + off)
        cx, cy = [(along, d), (d, along), (along, -d), (-d, along)][side]
        bw, bh = rng.uniform(0.5, 2.2, 2)
        # keep the driving centerline clear
        m = (h + wi) / 2
        if abs(max(abs(cx), abs(cy)) - m) < 2.6:
            continue
        w = w.add_box(cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2)
    return w


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--online", action="store_true")
    ap.add_argument("--async-backend", action="store_true",
                    help="overlap back-end solves with scan processing "
                    "(throughput mode; see outdoor_cfg docstring)")
    ap.add_argument("--laps", type=int, default=2)
    ap.add_argument("--arm", type=float, default=80.0)
    ap.add_argument("--scans", type=int, default=0, help="cap scan count")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from tpu_slam.utils.compile_cache import enable

        enable()  # persistent XLA compilation cache

    from tpu_slam import geometry_np as gnp
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.utils.evaluation import ate_rmse
    from tpu_slam.utils.profiling import StageTimer

    cfg = outdoor_cfg(async_backend=args.async_backend)
    arm, street = args.arm, 16.0
    h, wi = arm / 2, arm / 2 - street
    m = (h + wi) / 2
    lap = [[m, -m], [m, m], [-m, m], [-m, -m]]
    wps = np.array([[-m, -m]] + lap * args.laps + [[0.0, -m]])
    traj = sim.waypoint_trajectory(wps, speed=0.9, dt=0.1)
    if args.scans:
        traj = traj[: args.scans]
    world = outdoor_world(arm=arm, street=street, seed=4)
    print(f"outdoor mission: {len(traj)} scans, "
          f"{4 * 2 * m * args.laps:.0f} m route", file=sys.stderr)

    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.01, seed=6)
    rng = np.random.default_rng(3)
    odom = [seq.gt_poses[0].copy()]
    for i in range(1, len(seq.gt_poses)):
        d = gnp.relative(seq.gt_poses[i - 1], seq.gt_poses[i])
        d[:2] += rng.normal(0, 0.015, 2)
        d[2] += rng.normal(0, 0.003)
        odom.append(gnp.compose(odom[-1], d))
    odom = np.asarray(odom)
    scans = make_scan(
        seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32)
    )

    if args.online:
        import jax.numpy as jnp

        from tpu_slam.models.karto.pipeline import KartoSLAM

        slam = KartoSLAM(cfg)
        t0 = time.perf_counter()
        accepted = slam.run(scans, odom)
        slam.flush()
        wall = time.perf_counter() - t0
        est = slam.trajectory()
        gt = seq.gt_poses[accepted]
        print(
            f"online: {len(accepted)}/{len(traj)} accepted, "
            f"closures={slam.loop_closures}, wall={wall:.1f}s "
            f"({1e3 * wall / max(len(accepted), 1):.0f} ms/accepted)",
            file=sys.stderr,
        )
        print("stage timing:\n  " + slam.timer.report().replace(
            "\n", "\n  "), file=sys.stderr)
        ate_o = ate_rmse(odom[accepted], gt)
        ate_s = ate_rmse(est, gt)
        print(
            f"outdoor_online scans={len(traj)} accepted={len(accepted)} "
            f"closures={slam.loop_closures} wall_s={wall:.1f} "
            f"scans_per_sec={len(traj) / wall:.1f} "
            f"rtt_ms={1e3 * rtt:.2f} "
            f"ate_odom_m={ate_o:.3f} ate_slam_m={ate_s:.3f}"
        )
    else:
        from tpu_slam.models.offline import offline_slam

        timer = StageTimer()
        t0 = time.perf_counter()
        res = offline_slam(scans, cfg, odom=odom, timer=timer)
        wall = time.perf_counter() - t0
        ate_o = ate_rmse(odom, seq.gt_poses)
        ate_s = ate_rmse(res.poses, seq.gt_poses)
        print("stage timing:\n  "
              + timer.report().replace("\n", "\n  "), file=sys.stderr)
        print(
            f"outdoor_offline scans={len(traj)} loops={len(res.loops)} "
            f"anchors={res.anchors_accepted}/{res.anchors_tried} "
            f"wall_s={wall:.1f} scans_per_sec={len(traj) / wall:.1f} "
            f"ate_odom_m={ate_o:.3f} ate_slam_m={ate_s:.3f}"
        )


if __name__ == "__main__":
    main()
