"""Smoke run of the SLAM main path on one NVIDIA GPU.

    python chip_smoke.py               # five phases on one card
    python chip_smoke.py --multichip   # the mesh paths on four cards

Each phase drives a public entry point with the reference defaults of
``default_config()`` (360 beams, 10 PL-ICP rounds, a 1024² Hector map with
3 levels, doSPA(40)) and checks its output against a plain reference.
Every check carries its bound and the reason for it. A phase that raises or
misses a bound makes the script exit non-zero, and then the last line is
not printed. With no GPU the script exits non-zero before any phase runs.

Each phase prints one ``PHASE {...}`` JSON line: cold wall time (compile
included), warm wall time (results waited for with ``block_until_ready``
or fetched to the host), the checks, and the card's name and power limit.
The last line is ``{"ok": true, "device": {...}}``.

The phase functions take their sizes as arguments, so the tests run each of
them at a tiny size on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback

import numpy as np

# ATE of the same code on the CPU backend (JAX_PLATFORMS=cpu, same seeds and
# sizes): the offline mission measured on the host of an H100 machine, the
# online one on an 8-core x86 host. The GPU's bound is
# max(2 x this, 0.01 m): matches differ in the last float32 bits between
# backends, and a mission's ATE moves by a few millimetres with them.
CPU_ATE_KARTO_OFFLINE = 0.0019335723486372464
CPU_ATE_KARTO_ONLINE = 0.005830386914952465
ATE_FLOOR_M = 0.01


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def require_gpu():
    """The device list, or SystemExit when JAX's first device is no GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX's first device is "
            f"{devices[0].platform!r})"
        )
    return devices


def result_line(devices) -> str:
    """The contract's last line for a passing run."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def check(name: str, value: float, bound: float, why: str) -> dict:
    """One accuracy check: passes when value <= bound."""
    value = float(value)
    return {"name": name, "value": value, "bound": float(bound),
            "ok": bool(value <= bound), "why": why}


def _timed(fn, warm_runs: int = 3):
    """(result, cold_s, warm_s): the first call compiles; warm is the
    median of ``warm_runs`` further calls (NaN when there are none)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return out, cold, float(np.median(warm)) if warm else math.nan


# --- workloads ---------------------------------------------------------------


def plicp_pairs(n_pairs: int, beams: int):
    """Consecutive scan pairs along a simulated circle (the bench workload)
    and the ground-truth relative poses they should recover."""
    from tpu_slam import geometry_np as gnp
    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg, scan=dataclasses.replace(
            cfg.scan, num_beams=beams,
            angle_increment=2.0 * math.pi / beams),
    )
    traj = sim.circle_trajectory(n_pairs + 1, radius=1.6, angular_rate=0.6)
    world = sim.office_world(seed=11, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=4)
    scans = make_scan(seq.ranges, cfg.scan)
    valid = np.asarray(scans.valid)
    pts = np.where(valid[..., None], np.asarray(scans.points()), 0.0)
    pts = pts.astype(np.float32)
    gt_rel = gnp.relative(seq.gt_poses[:-1], seq.gt_poses[1:])
    # src = scan t+1, tgt = scan t: the match estimates scan t+1's pose in
    # scan t's frame
    return cfg, (pts[1:], valid[1:], pts[:-1], valid[:-1]), gt_rel


def ring_graph(n: int, seed: int = 17):
    """The bench's mission-shaped graph: a noisy odometry chain around two
    laps of a circle with loop closures every 50 nodes, started from the
    drifted chain."""
    from tpu_slam import geometry_np as gnp

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 4 * np.pi, n)
    gt = np.stack([10 * np.cos(th), 10 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    rels = gnp.relative(gt[:-1], gt[1:])
    edges = [(i, i + 1, rels[i] + rng.normal(0, 0.005, 3))
             for i in range(n - 1)]
    period = n // 2
    lrels = gnp.relative(gt[:-period], gt[period:])
    edges += [(i, i + period, lrels[i]) for i in range(0, n - period, 50)]
    init = [gt[0]]
    for i in range(n - 1):
        init.append(gnp.compose(init[-1], edges[i][2]))
    return np.asarray(init), edges, np.diag([1e4, 1e4, 4e4])


def ring_solver(n: int, cfg=None, mesh=None):
    """A PoseGraphSolver loaded with ``ring_graph(n)``, ready to compute."""
    from tpu_slam.config import SolverConfig
    from tpu_slam.solver.pose_graph import PoseGraphSolver

    init, edges, info = ring_graph(n)
    s = PoseGraphSolver(cfg or SolverConfig(), mesh=mesh)
    s.add_nodes(range(n), init)
    s.add_constraints(
        [e[0] for e in edges], [e[1] for e in edges], [e[2] for e in edges],
        informations=np.tile(info, (len(edges), 1, 1)))
    return s


def corridor_mission(laps: int, beams: int, arm: float = 9.0,
                     width: float = 2.6):
    """The bench's corridor loop: ``laps`` laps, drifting odometry."""
    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg, scan=dataclasses.replace(
            cfg.scan, num_beams=beams,
            angle_increment=2.0 * math.pi / beams,
            range_max=12.0, range_threshold=10.0),
    )
    traj = np.concatenate(
        [sim.loop_trajectory(arm=arm, width=width, speed=0.9)] * laps)
    world = sim.corridor_loop_world(arm=arm, width=width)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=8)
    rng = np.random.default_rng(3)
    odom = seq.gt_poses + np.cumsum(
        rng.normal(0, [0.02, 0.02, 0.004], (len(traj), 3)), 0)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32))
    return cfg, scans, seq, odom


def hector_mission(n_scans: int, map_size: int = 1024):
    from tpu_slam.config import default_config
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan

    cfg = default_config()
    cfg = dataclasses.replace(
        cfg, hector=dataclasses.replace(cfg.hector, map_size=map_size))
    traj = sim.circle_trajectory(n_scans, radius=1.5, angular_rate=0.6)
    world = sim.office_world(seed=31, size=10.0, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=3)
    scans = make_scan(seq.ranges, cfg.scan,
                      stamp=seq.stamps.astype(np.float32))
    return cfg, scans, seq


# --- phases ------------------------------------------------------------------


def phase_plicp(n_pairs: int = 512, beams: int = 360, warm_runs: int = 10):
    """Batched PL-ICP through make_batched_matcher, against plicp_match at
    Precision.HIGHEST on the same device and against ground truth."""
    import jax
    import jax.numpy as jnp

    from tpu_slam.ops.plicp import plicp_match
    from tpu_slam.parallel.distributed_step import make_batched_matcher

    cfg, arrays, gt_rel = plicp_pairs(n_pairs, beams)
    args = tuple(jnp.asarray(a) for a in arrays)
    guesses = jnp.zeros((n_pairs, 3), jnp.float32)
    match = make_batched_matcher(cfg)
    res, cold, warm = _timed(lambda: match(*args, guesses), warm_runs)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(
            lambda *a: plicp_match(*a, cfg.plicp, init_pose=guesses)
        )(*args)
    pose = np.asarray(res.pose, np.float64)
    rpose = np.asarray(ref.pose, np.float64)
    dxy = np.hypot(*(pose[:, :2] - rpose[:, :2]).T)
    dth = np.abs(np.angle(np.exp(1j * (pose[:, 2] - rpose[:, 2]))))
    gxy = np.hypot(*(pose[:, :2] - gt_rel[:, :2]).T)
    gth = np.abs(np.angle(np.exp(1j * (pose[:, 2] - gt_rel[:, 2]))))
    agree = (dxy <= 1e-4) & (dth <= 1e-4)
    return {
        "phase": "plicp", "cold_s": cold, "warm_s": warm,
        "scans_per_s": n_pairs / warm,
        "checks": [
            check("pairs_off_highest_ref", 1.0 - agree.mean(), 0.01,
                  "|dxy| and |dth| <= 1e-4 against plicp_match with "
                  "every product at Precision.HIGHEST on >= 99% of pairs: "
                  "a TF32 product would move poses by more; CPU runs "
                  "agree on every pair"),
            check("gt_xy_p99_m", np.quantile(gxy, 0.99), 0.005,
                  "99th percentile translation error against the "
                  "simulator: CPU runs of this workload sit below 2 mm "
                  "with 4 mm beam noise"),
            check("gt_theta_p99_rad", np.quantile(gth, 0.99), 0.002,
                  "99th percentile heading error against the simulator: "
                  "CPU runs sit below 1 mrad"),
        ],
    }


def phase_solver(ring_nodes: int = 1024, big_nodes: int = 3072,
                 warm_runs: int = 3):
    """PoseGraphSolver(SolverConfig()) on the bench ring and on a graph of
    at least 3,000 nodes, against the host float64 LM."""
    from tpu_slam.config import SolverConfig
    from tpu_slam.solver.pose_graph import _host_direct_lm, _sq_min_delta

    cfg = SolverConfig()
    out = {"phase": "solver", "checks": []}
    for label, n in (("ring", ring_nodes), ("big", big_nodes)):
        init, edges, info = ring_graph(n)
        stats = []

        def solve():
            s = ring_solver(n, cfg)
            stats.append(s.compute())
            return s.get_poses()

        poses, cold, warm = _timed(solve, warm_runs)
        final = stats[-1]
        E = len(edges)
        ei = np.array([e[0] for e in edges])
        ej = np.array([e[1] for e in edges])
        means = np.array([e[2] for e in edges])
        free = np.arange(n) > 0
        ref, _c0, ref_cost, _ = _host_direct_lm(
            init.copy(), ei, ej, means, np.tile(info, (E, 1, 1)),
            np.ones(E, bool), free, cfg.max_iterations, cfg.initial_lambda,
            _sq_min_delta(cfg.convergence_delta, np.float64))
        dxy = np.hypot(*(poses[:, :2] - ref[:, :2]).T).max()
        out[f"{label}_nodes"] = n
        out[f"{label}_cold_s"] = cold
        out[f"{label}_warm_s"] = warm
        out["checks"] += [
            check(f"{label}_cost_over_host", final.final_cost
                  / max(ref_cost, 1e-12), 1.05,
                  "final cost within 5% of the host float64 LM optimum: "
                  "the device LM is float32 and stops at a looser "
                  "||delta||^2 floor (1e-8)"),
            check(f"{label}_pose_xy_max_m", dxy, 0.25,
                  "every pose within 25 cm of the host float64 optimum: "
                  "float32 CG stops short in the 1,024-node ring's soft "
                  "modes, 0.19 m on the CPU backend as well"),
        ]
    out["cold_s"] = out["ring_cold_s"]
    out["warm_s"] = out["ring_warm_s"]
    return out


def phase_karto_offline(laps: int = 3, beams: int = 360, arm: float = 9.0,
                        width: float = 2.6,
                        cpu_ate: float = CPU_ATE_KARTO_OFFLINE,
                        warm_runs: int = 3):
    """offline_slam on the bench's corridor mission, against ground truth
    and the same code's CPU ATE."""
    from tpu_slam.models.offline import offline_slam
    from tpu_slam.utils.evaluation import ate_rmse

    cfg, scans, seq, odom = corridor_mission(laps, beams, arm, width)
    res, cold, warm = _timed(
        lambda: offline_slam(scans, cfg, odom=odom), warm_runs)
    ate = ate_rmse(res.poses, seq.gt_poses)
    T = len(seq.gt_poses)
    return {
        "phase": "karto_offline", "cold_s": cold, "warm_s": warm,
        "scans": T, "scans_per_s": T / warm, "loops": len(res.loops),
        "checks": [
            check("ate_m", ate, max(2 * cpu_ate, ATE_FLOOR_M),
                  "ATE against ground truth at most max(2 x the same "
                  "code's CPU ATE, 1 cm)"),
        ],
    }


def phase_karto_online(laps: int = 1, beams: int = 360, arm: float = 9.0,
                       width: float = 2.6,
                       cpu_ate: float = CPU_ATE_KARTO_ONLINE,
                       warm_runs: int = 1):
    """KartoSLAM(cfg).run over the corridor mission; it must close a loop."""
    from tpu_slam.models.karto.pipeline import KartoSLAM
    from tpu_slam.utils.evaluation import ate_rmse

    cfg, scans, seq, odom = corridor_mission(laps, beams, arm, width)
    runs = []

    def run():
        slam = KartoSLAM(cfg)
        acc = slam.run(scans, odom)
        runs.append((slam, acc))
        return slam.trajectory()

    est, cold, warm = _timed(run, warm_runs)
    slam, acc = runs[-1]
    ate = ate_rmse(est, seq.gt_poses[acc])
    return {
        "phase": "karto_online", "cold_s": cold, "warm_s": warm,
        "scans": len(seq.gt_poses), "accepted": len(acc),
        "ms_per_accepted_scan": 1e3 * warm / max(len(acc), 1),
        "loop_closures": slam.loop_closures,
        "checks": [
            check("missing_loop_closures", max(0, 1 - slam.loop_closures),
                  0, "one lap returns to its start: at least one loop "
                  "closure must be accepted"),
            check("ate_m", ate, max(2 * cpu_ate, ATE_FLOOR_M),
                  "ATE against ground truth at most max(2 x the same "
                  "code's CPU ATE, 1 cm)"),
        ],
    }


def phase_hector(n_scans: int = 200, map_size: int = 1024,
                 warm_runs: int = 1):
    """HectorSLAM(cfg).run on simulated scans, against ground truth."""
    import jax.numpy as jnp

    from tpu_slam.models.hector_slam import HectorSLAM
    from tpu_slam.utils.evaluation import ate_rmse

    cfg, scans, seq = hector_mission(n_scans, map_size)

    def run():
        slam = HectorSLAM(cfg)
        slam.last_pose = jnp.asarray(seq.gt_poses[0], jnp.float32)
        return slam.run(scans)

    est, cold, warm = _timed(run, warm_runs)
    ate = ate_rmse(est, seq.gt_poses, align=True)
    return {
        "phase": "hector", "cold_s": cold, "warm_s": warm,
        "scans": n_scans, "ms_per_scan": 1e3 * warm / n_scans,
        "checks": [
            check("aligned_ate_m", ate, ATE_FLOOR_M,
                  "aligned ATE against ground truth (cli.py's report) at "
                  "most max(2 x the CPU backend's 4.7 mm, 1 cm)"),
        ],
    }


PHASES = (phase_plicp, phase_solver, phase_karto_offline,
          phase_karto_online, phase_hector)


# --- the mesh paths ----------------------------------------------------------


def multichip(n_devices: int = 4, laps: int = 1, beams: int = 360,
              ring_nodes: int = 1024, hector_scans: int = 100,
              hector_map: int = 1024, arm: float = 9.0,
              width: float = 2.6, warm_runs: int = 1) -> dict:
    """The README's mesh paths on an ``n_devices`` mesh, each compared in
    this process with its single-device run. Each run is timed cold and
    warm."""
    import jax.numpy as jnp

    from tpu_slam.models.hector_slam import HectorSLAM
    from tpu_slam.models.karto.pipeline import KartoSLAM
    from tpu_slam.models.offline import offline_slam
    from tpu_slam.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices)
    times = {}

    def both(name, run):
        """run(mesh or None) on one device, then on the mesh."""
        outs = []
        for label, m in (("single", None), ("mesh", mesh)):
            out, cold, warm = _timed(lambda: run(m), warm_runs)
            times[f"{name}_{label}_cold_s"] = cold
            times[f"{name}_{label}_warm_s"] = warm
            outs.append(out)
        return outs

    cfg, scans, seq, odom = corridor_mission(laps, beams, arm, width)

    def karto(m):
        slam = KartoSLAM(cfg, mesh=m)
        acc = slam.run(scans, odom)
        return list(acc), slam.loop_closures, slam.trajectory()

    (a1, l1, t1), (a4, l4, t4) = both("karto", karto)

    def solve(m):
        s = ring_solver(ring_nodes, mesh=m)
        stats = s.compute()
        return s.get_poses(), stats.final_cost

    (p1, c1), (p4, c4) = both("solver", solve)
    hcfg, hscans, hseq = hector_mission(hector_scans, hector_map)

    def hector(m):
        h = HectorSLAM(hcfg, mesh=m)
        h.last_pose = jnp.asarray(hseq.gt_poses[0], jnp.float32)
        return h.run(hscans), h.to_ros_map()

    (e1, m1), (e4, m4) = both("hector", hector)
    base, sharded = both(
        "offline", lambda m: offline_slam(scans, cfg, odom=odom, mesh=m))
    checks = [
        check("karto_accepted_mismatch", float(a4 != a1), 0,
              "the same scans must be accepted"),
        check("karto_loops_mismatch", abs(l4 - l1), 0,
              "the same loop closures must be accepted"),
        check("karto_traj_max_m", np.abs(t4 - t1).max(), 5e-3,
              "psum sums in another order than the single-device LM; "
              "the mesh test's 5 mm bound"),
        check("solver_cost_rel", abs(c4 - c1) / max(c1, 1e-12), 0.01,
              "edge-sharded psum LM reaches the single-device optimum "
              "within float32 sum-order noise"),
        check("solver_pose_max_m", np.abs(p4[:, :2] - p1[:, :2]).max(),
              5e-3, "float32 CG in another sum order"),
        check("hector_traj_max_m", np.abs(e4 - e1).max(), 1e-4,
              "striped map with halo exchange: the mesh test's bound"),
        check("hector_map_cells_differ", float((m4 != m1).sum()), 0,
              "the striped rasterizer writes the same cells"),
        check("offline_chain_max",
              np.abs(sharded.chain_poses - base.chain_poses).max(), 1e-4,
              "per-pair matches agree to the last float32 bits (other "
              "batch shapes compile to other kernels); the differences "
              "accumulate along the integrated chain (1.2e-5 m over one "
              "352-scan lap on four H100s)"),
        check("offline_loops_mismatch",
              abs(len(sharded.loops) - len(base.loops)), 0,
              "the same loop closures must be accepted"),
        check("offline_pose_max_m",
              np.abs(sharded.poses - base.poses).max(), 5e-4,
              "the mesh test's bound"),
    ]
    return {"phase": "multichip", "devices": n_devices, **times,
            "checks": checks}


def _run_phase(fn, card: str) -> bool:
    try:
        res = fn()
    except Exception:
        traceback.print_exc()
        print("PHASE " + json.dumps({"phase": fn.__name__, "error": True,
                                     "card": card}), flush=True)
        return False
    res["card"] = card
    ok = all(c["ok"] for c in res["checks"])
    res["ok"] = ok
    print("PHASE " + json.dumps(res), flush=True)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the mesh paths, on four cards")
    args = ap.parse_args(argv)

    devices = require_gpu()
    from tpu_slam import native
    from tpu_slam.utils import compile_cache

    compile_cache.enable()
    card = card_info()
    print(card, flush=True)  # name, power limit: nvidia-smi's own line
    if args.multichip:
        if len(devices) < 4:
            raise SystemExit(f"--multichip needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        ok = _run_phase(lambda: multichip(4), card)
    else:
        print(f"native host library built: {native.available()}",
              flush=True)
        devices = devices[:1]
        ok = True
        for fn in PHASES:
            ok = _run_phase(fn, card) and ok
    if not ok:
        return 1
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
