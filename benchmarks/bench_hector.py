"""Micro-benchmark: Hector multi-resolution GN match + map update on one chip.

Reference numbers (author CPU, `9.基于Hector的栅格地图的构建.md:496-558`):
map compute 2.0-3.8 ms/scan, grid→ROS map conversion 49-55 ms.

    python benchmarks/bench_hector.py            # GPU
    python benchmarks/bench_hector.py --cpu
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from tpu_slam.utils.compile_cache import enable

        enable()  # persistent XLA compilation cache

    import jax.numpy as jnp

    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan, index_scan
    from tpu_slam.models.hector_slam import HectorSLAM

    cfg = default_config()  # 1024^2 grid @0.05 m, 3 levels, 360 beams
    slam = HectorSLAM(cfg)

    traj = sim.circle_trajectory(4, radius=1.5)
    world = sim.office_world(seed=3, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=1)
    scans = make_scan(seq.ranges, cfg.scan)
    s0 = index_scan(scans, 0)
    pose0 = jnp.asarray(seq.gt_poses[0], jnp.float32)
    slam.update_only(s0, pose0)

    s1 = index_scan(scans, 1)
    pts = jnp.where(
        s1.valid[..., None] & jnp.isfinite(s1.points()), s1.points(), 0.0
    )
    valid = s1.valid & jnp.all(jnp.isfinite(s1.points()), axis=-1)

    def timeit(name, fn, fetch):
        r = fn()
        _ = np.asarray(fetch(r))  # compile + barrier
        t0 = time.perf_counter()
        for _ in range(args.iters):
            r = fn()
        _ = np.asarray(fetch(r))
        dt = (time.perf_counter() - t0) / args.iters
        print(f"{name}: {dt * 1e3:.2f} ms", file=sys.stderr)
        print(f"{name}_ms={dt * 1e3:.2f}")
        return r

    timeit(
        "hector_match",
        lambda: slam._match_fn(slam.grids, pose0, pts, valid),
        lambda r: r[0],
    )
    # the XLA op-by-op matcher, timed on its own
    import jax
    from tpu_slam.ops import gridmap as gm
    from tpu_slam.ops.hector import match_multires

    gcfgs = tuple(slam.grid_cfgs)

    @jax.jit
    def xla_match(grids, pose, pts, valid):
        probs = [gm.occupancy_prob(g) for g in grids]
        return match_multires(probs, gcfgs, pose, pts, valid, cfg.hector)

    timeit(
        "hector_match_xla",
        lambda: xla_match(slam.grids, pose0, pts, valid),
        lambda r: r[0],
    )
    timeit(
        "hector_update",
        lambda: slam._update_fn(slam.grids, pose0, pts, valid),
        lambda r: r[0][:8],
    )
    timeit("hector_to_ros_map", lambda: slam.to_ros_map(), lambda r: r[:8])


if __name__ == "__main__":
    main()
