"""Benchmark entry — the three BASELINE.json metrics on one GPU.

Primary metric: scans matched per second (PL-ICP laser odometry workload,
lesson3). Baseline: the reference's PL-ICP odometry runs 4.2–8.1 ms/frame
on the author's CPU (`6.基于PL-ICP的激光雷达里程计.md:302-308`, see
BASELINE.md) → ~163 scans/s.

The ``extra`` dict carries the other two BASELINE metrics:
  * pose_graph_solve_ms — full LM run (doSPA(40) analogue) on a 1024-node
    mission-shaped graph, device-resident while_loop.
  * karto_scans_per_sec — whole-mission offline Karto pipeline (matching +
    loop closure + solves), end-to-end wall over the scan count.
  * karto_ate_m — ATE RMSE of that mission vs ground truth (golden parity
    against the reference C++ is asserted in tests/test_golden_*.py).

The workloads are chip_smoke.py's. Without a GPU the script exits
non-zero; a failing phase raises. Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "extra", "device", "card"}.
"""

import json
import time

import numpy as np

import chip_smoke


def bench_plicp(n_pairs: int = 512, iters: int = 20) -> float:
    import jax
    import jax.numpy as jnp

    from tpu_slam.parallel.distributed_step import make_batched_matcher

    cfg, arrays, _ = chip_smoke.plicp_pairs(n_pairs, 360)
    args = tuple(jnp.asarray(a) for a in arrays)
    guesses = jnp.zeros((n_pairs, 3), jnp.float32)
    match = make_batched_matcher(cfg)
    jax.block_until_ready(match(*args, guesses))  # compile
    t0 = time.perf_counter()
    for _ in range(iters):
        res = match(*args, guesses)
    jax.block_until_ready(res)
    return n_pairs * iters / (time.perf_counter() - t0)


def bench_solver_ms(n: int = 1024) -> float:
    """Best-of-3 full LM run on the mission-shaped ring graph."""
    chip_smoke.ring_solver(n).compute()  # compile
    best = np.inf
    for _ in range(3):
        s = chip_smoke.ring_solver(n)
        t0 = time.perf_counter()
        s.compute()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def bench_karto():
    """The 3-lap corridor mission through offline_slam: (median scans/s of
    3 warm runs, (min, max) scans/s, ATE)."""
    from tpu_slam.models.offline import offline_slam
    from tpu_slam.utils.evaluation import ate_rmse

    cfg, scans, seq, odom = chip_smoke.corridor_mission(3, 360)
    res = offline_slam(scans, cfg, odom=odom)  # compile
    dts = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = offline_slam(scans, cfg, odom=odom)
        dts.append(time.perf_counter() - t0)
    T = len(seq.gt_poses)
    return (T / float(np.median(dts)), (T / max(dts), T / min(dts)),
            float(ate_rmse(res.poses, seq.gt_poses)))


def main():
    from tpu_slam.utils.compile_cache import enable as enable_compile_cache

    devices = chip_smoke.require_gpu()
    enable_compile_cache()
    scans_per_sec = bench_plicp()
    baseline_cpu = 1000.0 / 6.15  # ≈163 scans/s (4.2–8.1 ms midpoint)
    ksps, spread, ate = bench_karto()
    extra = {
        "pose_graph_solve_ms": bench_solver_ms(),
        "karto_scans_per_sec": ksps,
        "karto_scans_per_sec_min": spread[0],
        "karto_scans_per_sec_max": spread[1],
        "karto_ate_m": ate,
    }
    print(json.dumps({
        "metric": "plicp_scan_match_throughput",
        "value": scans_per_sec,
        "unit": "scans/sec/device",
        "vs_baseline": scans_per_sec / baseline_cpu,
        "extra": extra,
        "device": json.loads(chip_smoke.result_line(devices[:1]))["device"],
        "card": chip_smoke.card_info(),
    }))


if __name__ == "__main__":
    main()
