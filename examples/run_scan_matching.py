"""Frame-to-frame scan matching (the lesson2/lesson3 workloads): the
point-to-point ICP vs PL-ICP comparison the reference builds its tutorial
around. The reference measures PCL ICP at ~0.12 s/frame
(scan_match_icp.cc:135-164, timing `4.基于ICP的帧间匹配.md:385-389`) and CSM
PL-ICP at ~0.5 ms/frame (scan_match_plicp.cc:38-300,
`5.基于PL-ICP的帧间匹配.md:318-331`); both here run as one batched device
program over the entire sequence at once.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from tpu_slam import geometry as geo
    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.ops.icp import icp_match
    from tpu_slam.parallel.distributed_step import make_batched_matcher

    cfg = default_config()
    B = args.frames
    traj = sim.circle_trajectory(B + 1, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=11, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004, seed=4)
    scans = make_scan(seq.ranges, cfg.scan)
    pts = np.where(
        np.asarray(scans.valid)[..., None], np.asarray(scans.points()), 0.0
    ).astype(np.float32)
    valid = np.asarray(scans.valid)

    src = jnp.asarray(pts[1:])
    srcv = jnp.asarray(valid[1:])
    tgt = jnp.asarray(pts[:-1])
    tgtv = jnp.asarray(valid[:-1])

    plicp = make_batched_matcher(cfg)

    # ground-truth frame-to-frame deltas in the sensor frame
    gt_d = np.stack(
        [
            np.asarray(
                geo.relative(
                    jnp.asarray(seq.gt_poses[i]), jnp.asarray(seq.gt_poses[i + 1])
                )
            )
            for i in range(B)
        ]
    )

    for name, fn, get_pose in (
        (
            "point-to-point ICP (lesson2)",
            lambda: icp_match(src, srcv, tgt, tgtv, cfg.icp),
            lambda r: np.asarray(r[0]),
        ),
        (
            "PL-ICP (lesson3)",
            lambda: plicp(src, srcv, tgt, tgtv, jnp.zeros((B, 3))),
            lambda r: np.asarray(r.pose),
        ),
    ):
        r = fn()
        _ = get_pose(r)  # compile + sync
        t0 = time.perf_counter()
        r = fn()
        est = get_pose(r)
        dt = time.perf_counter() - t0
        err = est - gt_d
        err[:, 2] = np.arctan2(np.sin(err[:, 2]), np.cos(err[:, 2]))
        print(
            f"{name}: {B} frames in {dt * 1e3:.1f} ms "
            f"({dt / B * 1e3:.3f} ms/frame); "
            f"delta RMSE trans {np.sqrt((err[:, :2] ** 2).mean()):.4f} m, "
            f"rot {np.sqrt((err[:, 2] ** 2).mean()):.4f} rad"
        )


if __name__ == "__main__":
    main()
