"""Micro-benchmark: pose-graph LM solve (the `doSPA(40)` analogue) on chip.

Builds the classic noisy ring graph: M odometry edges + loop-closure edges
every `stride` nodes, then times `PoseGraphSolver.compute()` — the fully
device-resident LM loop (lambda accept/reject in lax.while_loop) that
replaces `SysSPA2d::doSPA` (spa2d.cpp:425-609).

    python benchmarks/bench_solver.py --nodes 512
"""

import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument(
        "--schur", action="store_true",
        help="Schur-complement submap factorization (solver/schur.py)",
    )
    ap.add_argument("--submaps", type=int, default=8)
    ap.add_argument(
        "--reference", action="store_true",
        help="also time the compiled reference SysSPA2d on the same graph "
        "(dense + true sparse-Cholesky doSPA paths; parity/ harness)",
    )
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from tpu_slam.utils.compile_cache import enable

        enable()  # persistent XLA compilation cache

    import dataclasses

    from tpu_slam.config import default_config
    from tpu_slam.solver.pose_graph import PoseGraphSolver

    M = args.nodes
    rng = np.random.default_rng(0)

    # ground truth: circle of M poses
    th = np.linspace(0, 2 * math.pi, M, endpoint=False)
    R = 10.0
    gt = np.stack([R * np.cos(th), R * np.sin(th), th + math.pi / 2], -1)

    def rel(a, b):
        c, s = math.cos(a[2]), math.sin(a[2])
        d = b[:2] - a[:2]
        dth = math.atan2(math.sin(b[2] - a[2]), math.cos(b[2] - a[2]))
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1], dth])

    scfg = dataclasses.replace(
        default_config().solver,
        use_schur=args.schur, schur_submaps=args.submaps,
    )
    solver = PoseGraphSolver(scfg)
    # noisy initial guesses (drifting odometry)
    noise = np.cumsum(rng.normal(0, [0.02, 0.02, 0.004], (M, 3)), axis=0)
    for i in range(M):
        solver.add_node(i, gt[i] + noise[i])
    info = np.diag([50.0, 50.0, 100.0])
    for i in range(M):  # odometry ring
        j = (i + 1) % M
        solver.add_constraint(i, j, rel(gt[i], gt[j]), information=info)
    for i in range(0, M, 16):  # loop closures across the circle
        j = (i + M // 2) % M
        solver.add_constraint(i, j, rel(gt[i], gt[j]), information=info)

    init = gt + noise

    def reset():
        for i in range(M):
            solver.set_node_pose(i, init[i])

    stats = solver.compute()  # compile + solve once
    reset()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        stats = solver.compute()
        reset()  # each timed solve starts from the drifted guesses
    dt = (time.perf_counter() - t0) / args.iters
    print(
        f"solve {M} nodes / {solver.num_edges} edges: {dt * 1e3:.1f} ms, "
        f"iters={int(stats.iterations)} chi2 {float(stats.initial_cost):.1f}"
        f"->{float(stats.final_cost):.3f}",
        file=sys.stderr,
    )
    print(f"pose_graph_solve_ms={dt * 1e3:.2f}")

    if args.reference:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                        "tests"))
        from golden.ref_spa2d import RefSPA2d, load as ref_load

        if ref_load() is None:
            print("reference harness not buildable; skipping", file=sys.stderr)
            return

        def build(r):
            for i in range(M):
                r.add_node(init[i], i)
            for i in range(M):
                j = (i + 1) % M
                r.add_constraint(i, j, rel(gt[i], gt[j]), info)
            for i in range(0, M, 16):
                j = (i + M // 2) % M
                r.add_constraint(i, j, rel(gt[i], gt[j]), info)

        # the SpaSolver's actual path: SPARSE Cholesky (spa_solver.cc:51 →
        # spa2d.cpp:505 csp.doChol → cs_cholsol). Fresh instance per run —
        # doSPA mutates node poses.
        ts = []
        for _ in range(max(args.iters, 3)):
            with RefSPA2d() as r:
                build(r)
                t0 = time.perf_counter()
                r.do_spa_sparse(40)
                ts.append(time.perf_counter() - t0)
        print(f"reference_sparse_solve_ms={min(ts) * 1e3:.2f}")
        with RefSPA2d() as r:  # dense golden path, once (slow at 1k nodes)
            build(r)
            t0 = time.perf_counter()
            r.do_spa(40)
            print(f"reference_dense_solve_ms={(time.perf_counter() - t0) * 1e3:.2f}")


if __name__ == "__main__":
    main()
