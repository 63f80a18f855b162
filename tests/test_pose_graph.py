import dataclasses

import numpy as np
import pytest

from tpu_slam import geometry as geo
from tpu_slam.config import SolverConfig
from tpu_slam.solver.pose_graph import PoseGraphSolver

import jax.numpy as jnp


def rel(a, b):
    return np.asarray(
        geo.relative(jnp.asarray(a, jnp.float64), jnp.asarray(b, jnp.float64))
    )


def ring_graph(n=30, radius=5.0, noise=0.0, seed=0):
    """Ground-truth ring of poses + consecutive relative constraints."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack(
        [radius * np.cos(th), radius * np.sin(th), th + np.pi / 2], -1
    )
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    edges = []
    for i in range(n - 1):
        m = rel(gt[i], gt[i + 1]) + rng.normal(0, noise, 3)
        edges.append((i, i + 1, m))
    # loop closure
    m = rel(gt[n - 1], gt[0]) + rng.normal(0, noise, 3)
    edges.append((n - 1, 0, m))
    return gt, edges


def test_perfect_constraints_recover_exactly():
    gt, edges = ring_graph(noise=0.0)
    rng = np.random.default_rng(3)
    solver = PoseGraphSolver(SolverConfig())
    for i, p in enumerate(gt):
        init = p + (rng.normal(0, 0.2, 3) if i > 0 else 0.0)
        solver.add_node(i, init)
    info = np.diag([100.0, 100.0, 400.0])
    for i, j, m in edges:
        solver.add_constraint(i, j, m, information=info)
    stats = solver.compute()
    out = solver.get_poses()
    assert stats.final_cost < 1e-4 * stats.initial_cost
    # node 0 is the gauge — compare relative structure
    err = np.linalg.norm(out[:, :2] - gt[:, :2], axis=1)
    assert err.max() < 0.02, err.max()


def test_noisy_loop_reduces_drift():
    gt, edges = ring_graph(n=40, noise=0.01, seed=1)
    # integrate odometry only → drifted initial guesses
    init = [gt[0]]
    for i in range(len(gt) - 1):
        m = edges[i][2]
        init.append(
            np.asarray(
                geo.compose(jnp.asarray(init[-1]), jnp.asarray(m))
            )
        )
    init = np.asarray(init)
    drift0 = np.linalg.norm(init[:, :2] - gt[:, :2], axis=1).max()

    solver = PoseGraphSolver(SolverConfig())
    for i, p in enumerate(init):
        solver.add_node(i, p)
    info = np.diag([1e4, 1e4, 4e4])
    for i, j, m in edges:
        solver.add_constraint(i, j, m, information=info)
    stats = solver.compute()
    out = solver.get_poses()
    drift1 = np.linalg.norm(out[:, :2] - gt[:, :2], axis=1).max()
    assert stats.final_cost < stats.initial_cost
    assert drift1 < drift0 * 0.6, (drift0, drift1)
    # gauge fixed
    np.testing.assert_allclose(out[0], init[0], atol=1e-12)


def test_cg_matches_dense():
    gt, edges = ring_graph(n=24, noise=0.02, seed=5)
    rng = np.random.default_rng(7)
    outs = []
    for dense_limit in (10_000, 0):  # dense path, then CG path
        cfg = SolverConfig(use_dense_below=dense_limit)
        s = PoseGraphSolver(cfg)
        for i, p in enumerate(gt):
            s.add_node(i, p + (rng.standard_normal(3) * 0.0))
        info = np.diag([100.0, 100.0, 400.0])
        for i, j, m in edges:
            s.add_constraint(i, j, m, information=info)
        rng = np.random.default_rng(7)
        s.compute()
        outs.append(s.get_poses())
    np.testing.assert_allclose(outs[0], outs[1], atol=5e-3)


def test_covariance_input_path():
    """AddConstraint with covariance (SpaSolver inverts it, spa_solver.cc:60)."""
    s = PoseGraphSolver(SolverConfig())
    s.add_node(0, [0.0, 0.0, 0.0])
    s.add_node(1, [1.2, 0.1, 0.0])
    s.add_constraint(0, 1, [1.0, 0.0, 0.0], covariance=np.eye(3) * 0.01)
    stats = s.compute()
    out = s.get_poses()
    np.testing.assert_allclose(out[1], [1.0, 0.0, 0.0], atol=1e-4)
    assert stats.final_cost <= stats.initial_cost


def _solve_graph(cfg, init, edges, info, **solver_kw):
    s = PoseGraphSolver(cfg, **solver_kw)
    for i, p in enumerate(init):
        s.add_node(i, p)
    for i, j, m in edges:
        s.add_constraint(i, j, m, information=info)
    stats = s.compute()
    return s.get_poses(), stats


def test_mesh_lm_matches_single_device():
    """The FULL LM while_loop under shard_map (edges sharded over the
    8-device mesh, psum-assembled normal equations) must reproduce the
    single-device solve — both dense and CG paths."""
    from tpu_slam.parallel.mesh import make_mesh

    mesh = make_mesh()
    gt, edges = ring_graph(n=40, noise=0.02, seed=11)
    rng = np.random.default_rng(13)
    init = gt + rng.normal(0, 0.1, gt.shape) * (np.arange(len(gt)) > 0)[:, None]
    info = np.diag([100.0, 100.0, 400.0])
    for dense_limit in (10_000, 0):  # dense path, then CG path
        cfg = SolverConfig(use_dense_below=dense_limit)
        ref, rstats = _solve_graph(cfg, init, edges, info)
        out, mstats = _solve_graph(cfg, init, edges, info, mesh=mesh)
        # mesh partials psum in a different f32 order than the single-
        # device sum; 40 LM iterations amplify the low-bit difference to
        # ~2e-4 m on this graph (sub-mm, trajectory-neutral)
        np.testing.assert_allclose(out, ref, atol=5e-4)
        assert mstats.final_cost == pytest.approx(
            rstats.final_cost, rel=1e-2, abs=1e-6
        )


def test_cg_tolerance_early_out():
    """cg_tolerance stops CG once ‖r‖² ≤ tol·‖b‖²; a loose tolerance must
    still reach the same optimum through extra LM iterations, and tol=0
    (early-out disabled) reproduces the old fixed-iteration behavior."""
    gt, edges = ring_graph(n=32, noise=0.02, seed=21)
    rng = np.random.default_rng(23)
    init = gt + rng.normal(0, 0.05, gt.shape) * (np.arange(len(gt)) > 0)[:, None]
    info = np.diag([100.0, 100.0, 400.0])
    base, _ = _solve_graph(
        SolverConfig(use_dense_below=0, cg_tolerance=0.0), init, edges, info
    )
    tight, _ = _solve_graph(
        SolverConfig(use_dense_below=0, cg_tolerance=1e-12), init, edges, info
    )
    np.testing.assert_allclose(tight, base, atol=1e-3)


def test_f32_f64_divergence_bounded():
    """SURVEY §7 hard part (e): quantify the f32 LM
    against an f64 solve of the same large graph. The f32 path must land
    within centimeter-equivalent bounds of the f64 optimum."""
    import jax

    n = 1500
    rng = np.random.default_rng(31)
    # long noisy chain with periodic loop closures — the shape of a real
    # mission graph (odometry chain + near-chain links)
    th = np.linspace(0, 6 * np.pi, n)
    gt = np.stack(
        [8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], -1
    )
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    edges = []
    for i in range(n - 1):
        edges.append((i, i + 1, rel(gt[i], gt[i + 1]) + rng.normal(0, 0.005, 3)))
    period = n // 3  # revisits: one lap apart
    for i in range(0, n - period, 50):
        edges.append((i, i + period, rel(gt[i], gt[i + period])))
    init = [gt[0]]
    for i in range(n - 1):
        init.append(
            np.asarray(
                geo.compose(
                    jnp.asarray(init[-1], jnp.float64),
                    jnp.asarray(edges[i][2], jnp.float64),
                )
            )
        )
    init = np.asarray(init)
    info = np.diag([1e4, 1e4, 4e4])
    cfg = SolverConfig(use_dense_below=0)
    out32, s32 = _solve_graph(cfg, init, edges, info)
    jax.config.update("jax_enable_x64", True)
    try:
        out64, s64 = _solve_graph(cfg, init, edges, info, dtype=jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    # f32 must reach an optimum of the same quality...
    assert s32.final_cost < 1.5 * s64.final_cost + 1e-6, (s32, s64)
    # ...and the corrected trajectories must agree to sub-centimeter
    d = np.linalg.norm(out32[:, :2] - out64[:, :2], axis=1)
    assert d.max() < 0.01, d.max()


def test_mixed_schur_f64_path_matches_oracle():
    """The large-graph f64 dispatch (SolverConfig.f64_schur_above) — f32
    Schur factor + f64 PCG (mixed_schur_delta) — must reproduce an f64
    dense solve of the same mission-shaped graph. The graph carries
    multi-stride skip edges so it does NOT band under RCM (the offline
    outdoor shape that motivated the path, BENCHMARKS round 4)."""
    import dataclasses

    from tpu_slam import geometry_np as gnp
    from tpu_slam.config import SolverConfig
    from tpu_slam.solver.pose_graph import PoseGraphSolver

    rng = np.random.default_rng(11)
    n = 160
    th = np.linspace(0, 2 * np.pi, n)
    gt = np.stack([8 * np.cos(th), 8 * np.sin(th), th + np.pi / 2], -1)
    gt[:, 2] = np.arctan2(np.sin(gt[:, 2]), np.cos(gt[:, 2]))
    edges = []
    rels = gnp.relative(gt[:-1], gt[1:])
    for i in range(n - 1):
        edges.append((i, i + 1, rels[i] + rng.normal(0, 0.01, 3)))
    for s in (8, 32):  # skips break RCM banding (non-bandable like outdoor)
        rl = gnp.relative(gt[:-s], gt[s:])
        for i in range(0, n - s, s):
            edges.append((i, i + s, rl[i] + rng.normal(0, 0.004, 3)))
    init = [gt[0]]
    for i in range(n - 1):
        init.append(gnp.compose(init[-1], edges[i][2]))
    init = np.asarray(init)
    info = np.diag([1e4, 1e4, 4e4])

    def solve(cfg):
        s = PoseGraphSolver(cfg)
        for i in range(n):
            s.add_node(i, init[i])
        for i, j, m in edges:
            s.add_constraint(i, j, m, information=info)
        s.compute()
        return s.get_poses()

    # force the mixed f64 dispatch at this small size
    mixed = solve(
        SolverConfig(f64_schur_above=64, use_dense_below=32,
                     schur_submaps=8)
    )
    # oracle: plain dense f64 LM of the same graph
    import jax
    import jax.numpy as jnp

    with jax.enable_x64(True):
        s = PoseGraphSolver(
            SolverConfig(use_dense_below=4096), dtype=jnp.float64
        )
        for i in range(n):
            s.add_node(i, init[i])
        for i, j, m in edges:
            s.add_constraint(i, j, m, information=info)
        s.compute()
        want = s.get_poses()
    np.testing.assert_allclose(mixed, want, atol=5e-5)
