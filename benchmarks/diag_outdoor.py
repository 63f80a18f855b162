"""Diagnose the offline outdoor ATE.

Runs the outdoor offline mission, then decomposes the remaining error:
  * chain ATE (integrated PL-ICP odometry, pre-solve)
  * solved ATE (the shipped result)
  * f64 oracle ATE: the SAME pose graph re-solved to convergence in
    float64 scipy (sparse normal equations + LM) — separates "the solver
    under-converges" from "the graph's edges don't pin the trajectory"
  * error profile along the trajectory (where the meters live)

Usage: python benchmarks/diag_outdoor.py --laps 2 [--scans N]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def f64_lm_solve(T, edges, init, iters=60):
    """Reference-quality LM in f64 scipy sparse (gauge: node 0 fixed)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from tpu_slam import geometry_np as gnp

    poses = init.astype(np.float64).copy()
    ei = np.array([e[0] for e in edges])
    ej = np.array([e[1] for e in edges])
    means = np.stack([e[2] for e in edges]).astype(np.float64)
    infos = np.stack([e[3] for e in edges]).astype(np.float64)
    lam = 1e-4

    def residuals(p):
        rel = gnp.compose(gnp.inverse(p[ei]), p[ej])
        r = rel - means
        r[:, 2] = np.arctan2(np.sin(r[:, 2]), np.cos(r[:, 2]))
        return r

    def cost(p):
        r = residuals(p)
        return float(np.einsum("ei,eij,ej->", r, infos, r))

    c = cost(poses)
    for it in range(iters):
        # numeric Jacobians are fine at this scale; analytic would match
        r = residuals(poses)
        # analytic J blocks (pose_graph_2d_error_term.h:59-86 form)
        ci, si = np.cos(poses[ei, 2]), np.sin(poses[ei, 2])
        dx = poses[ej, 0] - poses[ei, 0]
        dy = poses[ej, 1] - poses[ei, 1]
        E = len(edges)
        Ji = np.zeros((E, 3, 3))
        Jj = np.zeros((E, 3, 3))
        Ji[:, 0, 0] = -ci
        Ji[:, 0, 1] = -si
        Ji[:, 0, 2] = -si * dx + ci * dy
        Ji[:, 1, 0] = si
        Ji[:, 1, 1] = -ci
        Ji[:, 1, 2] = -ci * dx - si * dy
        Ji[:, 2, 2] = -1.0
        Jj[:, 0, 0] = ci
        Jj[:, 0, 1] = si
        Jj[:, 1, 0] = -si
        Jj[:, 1, 1] = ci
        Jj[:, 2, 2] = 1.0
        # assemble sparse H, b
        WJi = np.einsum("eij,ejk->eik", infos, Ji)
        WJj = np.einsum("eij,ejk->eik", infos, Jj)
        Hii = np.einsum("eji,ejk->eik", Ji, WJi)
        Hij = np.einsum("eji,ejk->eik", Ji, WJj)
        Hjj = np.einsum("eji,ejk->eik", Jj, WJj)
        bi = np.einsum("eji,ej->ei", Ji, np.einsum("eij,ej->ei", infos, r))
        bj = np.einsum("eji,ej->ei", Jj, np.einsum("eij,ej->ei", infos, r))
        rows, cols, vals = [], [], []
        for (bl, ia, ja) in ((Hii, ei, ei), (Hij, ei, ej),
                             (np.transpose(Hij, (0, 2, 1)), ej, ei),
                             (Hjj, ej, ej)):
            rr = (ia[:, None, None] * 3 + np.arange(3)[None, :, None])
            cc = (ja[:, None, None] * 3 + np.arange(3)[None, None, :])
            rows.append(np.broadcast_to(rr, bl.shape).ravel())
            cols.append(np.broadcast_to(cc, bl.shape).ravel())
            vals.append(bl.ravel())
        H = sp.csr_matrix(
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=(3 * T, 3 * T),
        )
        b = np.zeros(3 * T)
        np.add.at(b, (ei[:, None] * 3 + np.arange(3)).ravel(), bi.ravel())
        np.add.at(b, (ej[:, None] * 3 + np.arange(3)).ravel(), bj.ravel())
        # gauge: clamp node 0
        mask = np.ones(3 * T, bool)
        mask[:3] = False
        Hf = H[mask][:, mask] + lam * sp.eye(3 * T - 3)
        step = spla.spsolve(Hf.tocsc(), -b[mask])
        new = poses.copy()
        new[1:] += step.reshape(-1, 3)
        new[:, 2] = np.arctan2(np.sin(new[:, 2]), np.cos(new[:, 2]))
        cn = cost(new)
        if cn < c:
            poses, c = new, cn
            lam = max(lam * 0.5, 1e-9)
            if float(np.dot(step, step)) < 1e-16:
                break
        else:
            lam *= 4.0
        if lam > 1e8:
            break
    return poses, c


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--laps", type=int, default=2)
    ap.add_argument("--scans", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        from tpu_slam.utils.compile_cache import enable

        enable()

    from bench_outdoor import outdoor_cfg, outdoor_world

    from tpu_slam import geometry_np as gnp
    from tpu_slam.data import simulator as sim
    from tpu_slam.data.scan import make_scan
    from tpu_slam.models.offline import offline_slam
    from tpu_slam.utils.evaluation import ate_rmse

    sys.path.insert(0, os.path.dirname(__file__))
    cfg = outdoor_cfg()
    arm, street = 80.0, 16.0
    h, wi = arm / 2, arm / 2 - street
    m = (h + wi) / 2
    lap = [[m, -m], [m, m], [-m, m], [-m, -m]]
    wps = np.array([[-m, -m]] + lap * args.laps + [[0.0, -m]])
    traj = sim.waypoint_trajectory(wps, speed=0.9, dt=0.1)
    if args.scans:
        traj = traj[: args.scans]
    world = outdoor_world(arm=arm, street=street, seed=4)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.01, seed=6)
    rng = np.random.default_rng(3)
    odom = [seq.gt_poses[0].copy()]
    for i in range(1, len(seq.gt_poses)):
        d = gnp.relative(seq.gt_poses[i - 1], seq.gt_poses[i])
        d[:2] += rng.normal(0, 0.015, 2)
        d[2] += rng.normal(0, 0.003)
        odom.append(gnp.compose(odom[-1], d))
    odom = np.asarray(odom)
    scans = make_scan(seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32))
    gt = seq.gt_poses

    t0 = time.perf_counter()
    res = offline_slam(scans, cfg, odom=odom)
    print(f"offline wall {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    T = len(gt)
    print(f"scans={T} loops={len(res.loops)}")
    print(f"ate_odom   = {ate_rmse(odom, gt):.3f}")
    print(f"ate_chain  = {ate_rmse(res.chain_poses, gt):.3f}")
    print(f"ate_solved = {ate_rmse(res.poses, gt):.3f}")

    # pull the solved graph out of the solver and re-solve in f64
    edges = res.solver._edges
    np.savez(
        "/tmp/outdoor_graph.npz",
        ei=np.array([e[0] for e in edges]),
        ej=np.array([e[1] for e in edges]),
        means=np.stack([e[2] for e in edges]),
        infos=np.stack([e[3] for e in edges]),
        chain=res.chain_poses, solved=res.poses, gt=gt, odom=odom,
    )
    print(f"edges={len(edges)}")
    t0 = time.perf_counter()
    oracle, c = f64_lm_solve(T, edges, res.chain_poses)
    print(f"f64 oracle solve {time.perf_counter() - t0:.1f}s "
          f"final cost {c:.4f}", file=sys.stderr)
    print(f"ate_f64_oracle = {ate_rmse(oracle, gt):.3f}")

    # error profile: aligned per-scan error of shipped vs oracle in 10 bins
    for name, est in (("solved", res.poses), ("oracle", oracle)):
        d = np.linalg.norm(est[:, :2] - gt[:, :2], axis=-1)
        prof = [float(np.sqrt(np.mean(
            d[k * T // 10:(k + 1) * T // 10] ** 2)))
            for k in range(10)]
        print(f"profile_{name} = "
              + " ".join(f"{p:.2f}" for p in prof))


if __name__ == "__main__":
    main()
