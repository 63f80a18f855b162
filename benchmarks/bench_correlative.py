"""Micro-benchmark: Karto correlative scan matcher on one chip.

Times the two matcher instances of the reference (`ScanMatcher::Create`,
Mapper.cpp:126-173) as used by the pipeline:

  * front-end: 0.3 m window @ 0.01 m, coarse 31x31x21 + fine, penalties
  * loop coarse: 8 m window @ 0.05 m, coarse 161x161x21, no fine

Each timing is a full fused device program (grid build + correlate +
covariances), barriered by a device-to-host fetch. Run on the GPU:

    python benchmarks/bench_correlative.py            # GPU
    python benchmarks/bench_correlative.py --cpu      # host CPU
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
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument(
        "--parts", action="store_true",
        help="also time grid build / coarse correlate separately",
    )
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from tpu_slam.utils.compile_cache import enable

        enable()  # persistent XLA compilation cache

    import jax
    import jax.numpy as jnp

    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.ops.correlative import CorrelativeMatcher, CorrelativeParams

    cfg = default_config()
    c, lp = cfg.correlative, cfg.loop

    # realistic base map: 64 scans around a loop (running-buffer bucket size)
    n_base = 64
    traj = sim.circle_trajectory(n_base, radius=1.8, angular_rate=0.35)
    world = sim.office_world(seed=5, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=2)
    scans = make_scan(seq.ranges, cfg.scan)
    pts = np.asarray(scans.points())
    valid = np.asarray(scans.valid) & np.isfinite(pts).all(-1)
    pts = np.where(valid[..., None], pts, 0.0).astype(np.float32)
    poses = seq.gt_poses.astype(np.float32)

    # world-frame base points (all scans flattened)
    cth, sth = np.cos(poses[:, 2:3]), np.sin(poses[:, 2:3])
    wx = poses[:, 0:1] + cth * pts[..., 0] - sth * pts[..., 1]
    wy = poses[:, 1:2] + sth * pts[..., 0] + cth * pts[..., 1]
    base_pts = jnp.asarray(np.stack([wx, wy], -1).reshape(-1, 2))
    base_valid = jnp.asarray(valid.reshape(-1))

    q = n_base // 2
    scan_pts = jnp.asarray(pts[q])
    beam_valid = jnp.asarray(valid[q])
    scan_pose = jnp.asarray(poses[q])

    rng_th = cfg.scan.range_threshold
    configs = {
        "frontend": (
            CorrelativeParams(
                search_size=c.correlation_search_space_dimension,
                resolution=c.correlation_search_space_resolution,
                smear_deviation=c.correlation_search_space_smear_deviation,
                range_threshold=rng_th,
                angle_offset=c.coarse_search_angle_offset,
                angle_res=c.coarse_angle_resolution,
                fine_angle_offset=c.fine_search_angle_offset,
            ),
            dict(do_penalize=True, do_fine=True),
        ),
        "loop_coarse": (
            CorrelativeParams(
                search_size=lp.loop_search_space_dimension,
                resolution=lp.loop_search_space_resolution,
                smear_deviation=lp.loop_search_space_smear_deviation,
                range_threshold=rng_th,
                angle_offset=c.coarse_search_angle_offset,
                angle_res=c.coarse_angle_resolution,
                fine_angle_offset=c.fine_search_angle_offset,
            ),
            dict(do_penalize=False, do_fine=False),
        ),
    }

    def time_part(name, fn, *a):
        r = fn(*a)
        _ = np.asarray(jax.tree_util.tree_leaves(r)[0])
        t0 = time.perf_counter()
        for _ in range(args.iters):
            r = fn(*a)
        _ = np.asarray(jax.tree_util.tree_leaves(r)[0])
        dt = (time.perf_counter() - t0) / args.iters
        print(f"  {name}: {dt * 1e3:.2f} ms", file=sys.stderr)
        return dt

    for name, (params, kw) in configs.items():
        m = CorrelativeMatcher(params, use_response_expansion=False)
        if args.parts:
            from tpu_slam.ops.correlative import (
                build_correlation_grid, correlate_scan,
            )

            p = params
            n_ang = int(round(p.angle_offset * 2.0 / p.angle_res)) + 1
            gb = jax.jit(
                lambda c, pts, v: build_correlation_grid(p, c, pts, v)
            )
            grid = gb(scan_pose[:2], base_pts, base_valid)
            corr = jax.jit(
                lambda g, sp: correlate_scan(
                    g, p, sp[:2], sp, scan_pts, beam_valid,
                    m.coarse_x, m.coarse_y, n_ang, p.angle_offset,
                    p.angle_res, do_penalize=kw["do_penalize"],
                )
            )
            print(f"{name} parts:", file=sys.stderr)
            time_part("grid_build", gb, scan_pose[:2], base_pts, base_valid)
            time_part("coarse_correlate", corr, grid, scan_pose)
        r = m.match(
            base_pts, base_valid, scan_pts, beam_valid, scan_pose, **kw
        )
        _ = np.asarray(r.pose)  # compile + barrier
        t0 = time.perf_counter()
        for _ in range(args.iters):
            r = m.match(
                base_pts, base_valid, scan_pts, beam_valid, scan_pose, **kw
            )
        _ = np.asarray(r.pose)
        dt = (time.perf_counter() - t0) / args.iters
        print(
            f"{name}: {dt * 1e3:.1f} ms/match  grid={params.grid_size}  "
            f"response={float(r.response):.3f}",
            file=sys.stderr,
        )
        print(f"{name}_ms={dt * 1e3:.2f}")


if __name__ == "__main__":
    main()
