"""Golden-parity tests: PoseGraphSolver vs the REAL reference SPA2d.

The reference solver (SysSPA2d::doSPA, spa2d.cpp:425-609) is compiled
unmodified and driven through tests/golden/ref_spa2d. Same graphs go through
both solvers; corrected poses and final costs must agree. The reference runs
in f64, tpu_slam's LM in f32 — tolerances quantify that gap (also feeding
the dtype study).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tpu_slam import geometry as geo
from tpu_slam.config import default_config
from tpu_slam.solver.pose_graph import PoseGraphSolver

from tests.golden import ref_spa2d

pytestmark = pytest.mark.skipif(
    ref_spa2d.load() is None, reason="reference SPA2d not buildable"
)


def rel(a, b):
    return np.asarray(geo.relative(jnp.asarray(a), jnp.asarray(b)))


def compose(a, b):
    return np.asarray(geo.compose(jnp.asarray(a), jnp.asarray(b)))


def circle_graph(n=60, step=0.5, noise=0.01, seed=0, loop_info=1000.0):
    """Noisy odometry chain around a circle + one strong loop closure."""
    rng = np.random.default_rng(seed)
    gt = []
    p = np.zeros(3)
    for _ in range(n):
        gt.append(p.copy())
        p = compose(p, np.array([step, 0.0, 2 * np.pi / n]))
    gt = np.stack(gt)
    edges = []
    for i in range(n - 1):
        m = rel(gt[i], gt[i + 1]) + rng.normal(0, noise, 3)
        edges.append((i, i + 1, m, np.diag([100.0, 100.0, 400.0])))
    edges.append(
        (n - 1, 0, rel(gt[n - 1], gt[0]),
         np.diag([loop_info, loop_info, 4 * loop_info]))
    )
    init = [gt[0]]
    for i, j, m, P in edges[:-1]:
        init.append(compose(init[-1], m))
    return gt, np.stack(init), edges


def solve_both(init, edges, niter=40):
    n = len(init)
    with ref_spa2d.RefSPA2d() as ref:
        for i in range(n):
            ref.add_node(init[i], i)
        for i, j, m, P in edges:
            assert ref.add_constraint(i, j, m, P)
        cost0_ref = ref.cost()
        ref.do_spa(niter)
        cost_ref = ref.cost()
        _, ref_poses = ref.poses()

    solver = PoseGraphSolver(default_config().solver)
    for i in range(n):
        solver.add_node(i, init[i])
    for i, j, m, P in edges:
        solver.add_constraint(i, j, m, information=P)
    stats = solver.compute(max_iterations=niter)
    mine = solver.get_poses()
    return ref_poses, cost0_ref, cost_ref, mine, stats


def test_golden_spa2d_circle():
    gt, init, edges = circle_graph()
    ref_poses, cost0_ref, cost_ref, mine, stats = solve_both(init, edges)
    # identical residual model: initial costs match to f32 eps
    assert abs(stats.initial_cost - cost0_ref) / cost0_ref < 1e-5
    # converged costs match closely; poses within f32-solver tolerance
    assert abs(stats.final_cost - cost_ref) / max(cost_ref, 1e-9) < 1e-3
    d = mine - ref_poses
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    assert np.abs(d).max() < 2e-3, np.abs(d).max()


def test_golden_spa2d_multi_loop():
    """Grid-walk graph with several loop closures + anisotropic precisions
    (rotated information matrices, not just diagonals)."""
    rng = np.random.default_rng(3)
    n = 80
    gt = [np.zeros(3)]
    for i in range(1, n):
        turn = rng.choice([0.0, np.pi / 2, -np.pi / 2], p=[0.7, 0.15, 0.15])
        gt.append(compose(gt[-1], np.array([0.4, 0.0, turn])))
    gt = np.stack(gt)
    edges = []
    for i in range(n - 1):
        m = rel(gt[i], gt[i + 1]) + rng.normal(0, 0.015, 3)
        a = rng.uniform(0, np.pi)
        R = np.array(
            [
                [np.cos(a), -np.sin(a), 0],
                [np.sin(a), np.cos(a), 0],
                [0, 0, 1],
            ]
        )
        P = R @ np.diag(rng.uniform(50, 300, 3)) @ R.T
        edges.append((i, i + 1, m, P))
    # loop closures between revisited cells
    for _ in range(6):
        i, j = sorted(rng.integers(0, n, 2))
        if j - i < 10:
            continue
        edges.append(
            (i, j, rel(gt[i], gt[j]), np.diag([800.0, 800.0, 3200.0]))
        )
    init = [gt[0]]
    for i, j, m, P in edges[: n - 1]:
        init.append(compose(init[-1], m))
    init = np.stack(init)

    ref_poses, cost0_ref, cost_ref, mine, stats = solve_both(init, edges)
    assert abs(stats.initial_cost - cost0_ref) / cost0_ref < 1e-5
    assert abs(stats.final_cost - cost_ref) / max(cost_ref, 1e-9) < 5e-3
    d = mine - ref_poses
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    assert np.abs(d).max() < 5e-3, np.abs(d).max()


def test_golden_spa2d_lm_schedule():
    """The LM accept/reject schedule matches: on a graph where the first
    step overshoots, both solvers must still land on the same optimum."""
    gt, init, edges = circle_graph(n=30, noise=0.05, seed=9, loop_info=1e5)
    ref_poses, cost0_ref, cost_ref, mine, stats = solve_both(init, edges)
    assert abs(stats.final_cost - cost_ref) / max(cost_ref, 1e-9) < 5e-3
    d = mine - ref_poses
    d[:, 2] = np.arctan2(np.sin(d[:, 2]), np.cos(d[:, 2]))
    assert np.abs(d).max() < 5e-3, np.abs(d).max()


def test_golden_spa2d_sparse_matches_dense():
    """The reference's DEFAULT sparse-Cholesky doSPA path (spa2d.cpp:505
    csp.doChol → cs_cholsol, the branch SpaSolver actually runs) must agree
    with the dense-Cholesky golden path: same normal equations, same LM
    schedule, different linear solver. This validates the harness's
    from-scratch CSparse implementation (parity/cs_impl.cpp) and gives the
    solver benchmarks an honest CPU-side denominator."""
    gt, init, edges = circle_graph(n=120, seed=3)

    def build(r):
        for i in range(len(init)):
            r.add_node(init[i], i)
        for i, j, m, P in edges:
            assert r.add_constraint(i, j, m, P)

    with ref_spa2d.RefSPA2d() as dense, ref_spa2d.RefSPA2d() as sparse:
        build(dense)
        build(sparse)
        dense.do_spa(40)
        sparse.do_spa_sparse(40)
        cd, cs_ = dense.cost(), sparse.cost()
        _, pd = dense.poses()
        _, ps = sparse.poses()
    assert abs(cd - cs_) <= 1e-6 * max(cd, 1e-12)
    np.testing.assert_allclose(ps, pd, atol=1e-6)
