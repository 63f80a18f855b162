"""Scaling-efficiency benchmark: batched PL-ICP matching throughput vs
device count (the BASELINE "scans/s scaling measured at 1 chip, 1 host,
N >= 2 hosts" harness).

Runs the data-parallel matcher (`parallel/distributed_step.make_batched_matcher`)
at a fixed per-device batch (weak scaling) on meshes of 1, 2, 4, ... D
devices and reports scans/s plus efficiency vs the single-device rate.

By default the bench runs on a virtual CPU mesh (--devices N via
xla_force_host_platform_device_count); --gpu measures the same sharded
program on real GPUs (batch axis sharded; XLA partitions with no
collectives).

NOTE on virtual-mesh numbers: the N virtual CPU "devices" share ONE host's
physical cores, so weak-scaling "efficiency" here measures core contention,
not parallel overhead — the honest signature is TOTAL throughput staying
flat at the host's capacity as devices double. The real scaling claim is
structural and asserted in tests/test_parallel.py: the partitioned HLO of
this program contains ZERO collectives, so on a real slice the per-chip
rate is independent of N (no interconnect traffic to lose efficiency to).

    python benchmarks/bench_scaling.py --devices 8
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--per-device-batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--gpu", action="store_true",
                    help="use the GPUs instead of a virtual CPU mesh")
    args = ap.parse_args()

    if not args.gpu:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()
    import jax

    if not args.gpu:
        jax.config.update("jax_platforms", "cpu")
    else:
        from tpu_slam.utils.compile_cache import enable

        enable()  # persistent XLA compilation cache

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.parallel.distributed_step import make_batched_matcher

    cfg = default_config()
    devs = jax.devices()[: args.devices]
    base_rate = None

    sizes = []
    d = 1
    while d <= len(devs):
        sizes.append(d)
        d *= 2

    for nd in sizes:
        B = args.per_device_batch * nd
        traj = sim.circle_trajectory(B + 1, radius=1.6, angular_rate=0.6)
        world = sim.office_world(seed=11, clear_path=traj)
        seq = sim.simulate_sequence(
            world, traj, cfg.scan, noise_std=0.004, seed=4
        )
        scans = make_scan(seq.ranges, cfg.scan)
        pts = np.where(
            np.asarray(scans.valid)[..., None], np.asarray(scans.points()),
            0.0,
        ).astype(np.float32)
        valid = np.asarray(scans.valid)

        mesh = Mesh(np.asarray(devs[:nd]), ("data",))
        sh = NamedSharding(mesh, P("data"))
        put = lambda x: jax.device_put(jnp.asarray(x), sh)
        src = put(pts[1:])
        srcv = put(valid[1:])
        tgt = put(pts[:-1])
        tgtv = put(valid[:-1])
        guesses = put(np.zeros((B, 3), np.float32))

        match = make_batched_matcher(cfg)
        res = match(src, srcv, tgt, tgtv, guesses)
        _ = np.asarray(res.pose)  # compile + barrier
        t0 = time.perf_counter()
        for _ in range(args.iters):
            res = match(src, srcv, tgt, tgtv, guesses)
        _ = np.asarray(res.pose)
        dt = (time.perf_counter() - t0) / args.iters
        rate = B / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * nd)
        print(
            f"devices={nd:2d}  batch={B:4d}  {rate:9.0f} scans/s  "
            f"efficiency={eff * 100:5.1f}%",
            file=sys.stderr,
        )
        print(f"devices_{nd}_scans_per_s={rate:.0f} efficiency={eff:.3f}")


if __name__ == "__main__":
    main()
