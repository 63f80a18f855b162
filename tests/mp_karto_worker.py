"""Worker for the multi-process (multi-host) KartoSLAM front-end test.

Each process owns 2 virtual CPU devices; the global mesh spans both
processes (jax.distributed, Gloo collectives standing in for DCN). The
FULL online pipeline — correlative front-end, ring-pass loop-candidate
search over the cross-process keyframe shards, edge-sharded psum LM
back-end — runs against the same mission on every process and must
reproduce the single-device result exactly (accepts, closures,
trajectory). This is the SURVEY §5 "keyframe store sharded across hosts"
capability.

Usage: python tests/mp_karto_worker.py <process_id> <num_processes> <port>
"""

import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    sys.path.insert(0, os.path.dirname(__file__))
    from tpu_slam.parallel import multihost

    multihost.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc

    import numpy as np

    from test_karto import drifted_odometry, small_karto_cfg

    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.models.karto.pipeline import KartoSLAM

    cfg = small_karto_cfg()
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=8)
    odom = drifted_odometry(seq.gt_poses, seed=3)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32))

    # single-device reference (identical on every process)
    ref = KartoSLAM(cfg)
    acc_ref = ref.run(scans, odom)
    assert ref.loop_closures >= 1, "reference mission closed no loops"

    # the same mission over the cross-process mesh
    mesh = multihost.global_mesh()
    slam = KartoSLAM(cfg, mesh=mesh)
    acc = slam.run(scans, odom)

    assert list(acc) == list(acc_ref), (
        f"accepts diverged: {len(acc)} vs {len(acc_ref)}"
    )
    assert slam.loop_closures == ref.loop_closures, (
        slam.loop_closures, ref.loop_closures,
    )
    est, est_ref = slam.trajectory(), ref.trajectory()
    np.testing.assert_allclose(est, est_ref, atol=5e-3)

    print(f"proc {pid}: KARTO OK ({jax.process_count()} processes, "
          f"{len(acc)} accepted, {slam.loop_closures} closures)",
          flush=True)

    # timed rung: wall per
    # accepted scan of the FULL mesh mission, warm (the correctness run
    # above compiled every program), best-of-2
    if "--timed" in sys.argv:
        import time

        best, acc_t, slam_t = None, [], None
        for _ in range(2):
            slam_t = KartoSLAM(cfg, mesh=mesh)
            t0 = time.perf_counter()
            acc_t = slam_t.run(scans, odom)
            slam_t.flush()
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        ms = best * 1e3 / max(len(acc_t), 1)
        print(f"proc {pid}: timed_karto wall_s={best:.2f} "
              f"accepted={len(acc_t)} ms_per_accepted={ms:.1f}",
              flush=True)
        if pid == 0:
            print("stage timing:\n  "
                  + slam_t.timer.report().replace("\n", "\n  "),
                  flush=True)


if __name__ == "__main__":
    main()
