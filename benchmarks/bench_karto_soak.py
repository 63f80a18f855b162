"""Multi-lap Karto endurance run: store growth, repeated loop closures,
solver executable reuse.

A mission that revisits the same corridor loop N times closes a loop on
every lap at a different graph size — the stress case for (a) the
device-resident scan store growth buckets and (b) the LM program's shape
cache (a fresh shape = a fresh compile).
Reports compile count + dispatch seconds per closure alongside the e2e
numbers. Reference analogue: karto rebuilds/optimizes continuously over a
whole mission (Mapper.cpp:2050-2070).

    python benchmarks/bench_karto_soak.py --laps 3
    python benchmarks/bench_karto_soak.py --cpu --laps 2   # CPU smoke
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
    ap.add_argument("--sync", action="store_true", help="blocking back-end")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from tpu_slam.utils.compile_cache import enable

        enable()  # persistent XLA compilation cache

    import jax.numpy as jnp

    from tpu_slam import geometry as geo
    import tpu_slam.solver.pose_graph as pg
    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.models.karto.pipeline import KartoSLAM
    from tpu_slam.utils.evaluation import ate_rmse

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(
            cfg.scan, num_beams=180, range_max=6.0, range_threshold=5.0
        ),
        correlative=dataclasses.replace(
            cfg.correlative, correlation_search_space_resolution=0.02
        ),
        loop=dataclasses.replace(
            cfg.loop, loop_search_space_dimension=4.0,
            loop_search_maximum_distance=3.0,
            loop_match_minimum_chain_size=5,
        ),
        karto=dataclasses.replace(
            cfg.karto, async_loop_closure=not args.sync
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
    scans = make_scan(seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32))

    # instrument solver dispatches: fresh compiles + dispatch wall
    dispatches = []
    orig = pg.PoseGraphSolver.compute_async

    def patched(self, max_iterations=None):
        n0 = len(self._lm_cache)
        t0 = time.perf_counter()
        r = orig(self, max_iterations)
        dispatches.append(
            (len(self._lm_cache) - n0, time.perf_counter() - t0,
             self.num_nodes, self.num_edges)
        )
        return r

    pg.PoseGraphSolver.compute_async = patched
    try:
        slam = KartoSLAM(cfg)
        t0 = time.perf_counter()
        accepted = slam.run(scans, odom)
        wall = time.perf_counter() - t0
    finally:
        pg.PoseGraphSolver.compute_async = orig

    est = slam.trajectory()
    gt = seq.gt_poses[accepted]
    n_compiles = sum(d[0] for d in dispatches)
    disp_s = sum(d[1] for d in dispatches)
    print(
        f"laps={args.laps} scans={len(accepted)}/{len(traj)} wall={wall:.1f}s"
        f" closures={slam.loop_closures} edges={slam.solver.num_edges}",
        file=sys.stderr,
    )
    print(
        f"solver: {len(dispatches)} dispatches, {n_compiles} fresh compiles,"
        f" {disp_s:.2f}s total dispatch wall", file=sys.stderr,
    )
    for d in dispatches:
        print(f"  compile={d[0]} dispatch={d[1]:.2f}s nodes={d[2]}"
              f" edges={d[3]}", file=sys.stderr)
    ate_odom = ate_rmse(odom[accepted], gt)
    ate_slam = ate_rmse(est, gt)
    print(f"ATE odom={ate_odom:.4f} m slam={ate_slam:.4f} m", file=sys.stderr)
    print("stage timing:\n  " + slam.timer.report().replace("\n", "\n  "),
          file=sys.stderr)
    print(
        f"soak_wall_s={wall:.1f} soak_ms_per_scan="
        f"{1e3 * wall / max(len(accepted), 1):.0f} "
        f"solver_compiles={n_compiles} solver_dispatch_s={disp_s:.2f} "
        f"ate_slam_m={ate_slam:.4f}"
    )


if __name__ == "__main__":
    main()
