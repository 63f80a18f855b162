"""Worker for the true multi-process (jax.distributed) test.

Each process owns 2 virtual CPU devices; the global mesh spans all
processes (the N≥2-hosts rung of BASELINE's scale-out axis, with Gloo
cross-process collectives standing in for DCN). Runs the edge-sharded
distributed LM delta on a ring pose graph and checks it against the
locally computed single-device dense solve.

Usage: python tests/mp_worker.py <process_id> <num_processes> <port>
"""

import os
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tpu_slam.parallel import multihost

    multihost.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc
    n_dev = jax.device_count()
    assert n_dev == 2 * nproc, n_dev

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_slam.solver.distributed import make_distributed_lm_delta
    from tpu_slam.solver.pose_graph import dense_solve, normal_equations

    # deterministic ring graph, identical on every process
    rng = np.random.default_rng(0)
    M = 17
    th = np.linspace(0, 2 * np.pi, M, endpoint=False)
    gt = np.stack([5 * np.cos(th), 5 * np.sin(th), th], -1).astype(np.float32)
    ei = (np.arange(M) % M).astype(np.int32)
    ej = ((np.arange(M) + 1) % M).astype(np.int32)
    means = []
    for i in range(M):
        a, b = gt[ei[i]], gt[ej[i]]
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        m = np.array(
            [c * d[0] + s * d[1], -s * d[0] + c * d[1], b[2] - a[2]]
        )
        m[2] = np.arctan2(np.sin(m[2]), np.cos(m[2]))
        means.append(m + rng.normal(0, 0.01, 3))
    means = np.asarray(means, np.float32)
    E = M
    pad = (-E) % n_dev
    Ep = E + pad
    eip = np.concatenate([ei, np.zeros(pad, np.int32)])
    ejp = np.concatenate([ej, np.zeros(pad, np.int32)])
    meansp = np.concatenate([means, np.zeros((pad, 3), np.float32)])
    infos = np.tile(np.eye(3, dtype=np.float32) * 50, (Ep, 1, 1))
    mask = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
    free = np.arange(M) > 0
    poses = gt + np.random.default_rng(1).normal(0, 0.05, gt.shape).astype(
        np.float32
    )
    poses[0] = gt[0]
    lam = jnp.float32(1e-3)

    # local single-device reference (full data is host-replicated)
    Hd, Hij, b = normal_equations(
        jnp.asarray(poses), jnp.asarray(eip), jnp.asarray(ejp),
        jnp.asarray(meansp), jnp.asarray(infos), jnp.asarray(mask), M,
    )
    want = np.asarray(
        dense_solve(Hd, Hij, jnp.asarray(eip), jnp.asarray(ejp), b, lam,
                    jnp.asarray(free))
    )

    # global arrays over the multi-process mesh
    mesh = multihost.global_mesh()
    shard = NamedSharding(mesh, P("data"))
    rep = NamedSharding(mesh, P())

    def mk(x, sharding):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )

    args = (
        mk(poses, rep), mk(eip, shard), mk(ejp, shard), mk(meansp, shard),
        mk(infos, shard), mk(mask, shard), lam, mk(free, rep),
    )
    got_g = make_distributed_lm_delta(mesh, M)(*args)
    # the delta is replicated; every process reads its addressable shard
    got = np.asarray(got_g.addressable_shards[0].data)
    np.testing.assert_allclose(got, want, atol=2e-4)

    # the PRODUCTION solver across the multi-process mesh: the full LM
    # while_loop under shard_map, edges sharded over both processes'
    # devices — must match a plain single-device solve of the same graph
    from tpu_slam.config import SolverConfig
    from tpu_slam.solver.pose_graph import PoseGraphSolver

    def build(solver):
        for i in range(M):
            solver.add_node(i, poses[i])
        for k in range(E):
            solver.add_constraint(
                int(ei[k]), int(ej[k]), means[k],
                information=np.eye(3) * 50,
            )
        return solver

    ref = build(PoseGraphSolver(SolverConfig()))
    ref.compute()
    dist = build(PoseGraphSolver(SolverConfig(), mesh=mesh))
    dist.compute()
    np.testing.assert_allclose(
        dist.get_poses(), ref.get_poses(), atol=5e-4
    )

    # optional timed rung: a bigger ring solved on the
    # multi-process mesh, wall-clock printed per process
    if "--timed" in sys.argv:
        import time

        Mt = int(sys.argv[sys.argv.index("--timed") + 1])
        rng2 = np.random.default_rng(1)
        th2 = np.linspace(0, 2 * np.pi, Mt, endpoint=False)
        gt2 = np.stack(
            [10 * np.cos(th2), 10 * np.sin(th2), th2], -1
        ).astype(np.float64)
        tsolver = PoseGraphSolver(SolverConfig(), mesh=mesh)
        for i in range(Mt):
            tsolver.add_node(i, gt2[i] + rng2.normal(0, 0.05, 3))
        for i in range(Mt):
            j = (i + 1) % Mt
            a, b = gt2[i], gt2[j]
            c, s_ = np.cos(a[2]), np.sin(a[2])
            d = b[:2] - a[:2]
            m = np.array([c * d[0] + s_ * d[1], -s_ * d[0] + c * d[1],
                          np.arctan2(np.sin(b[2] - a[2]),
                                     np.cos(b[2] - a[2]))])
            tsolver.add_constraint(i, j, m, information=np.eye(3) * 50)
        tsolver.compute()  # compile
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            tsolver.compute()
            best = min(best, time.perf_counter() - t0)
        print(f"proc {pid}: timed_solve_ms={best * 1e3:.1f} M={Mt}",
              flush=True)

    print(f"proc {pid}: OK ({jax.process_count()} processes, "
          f"{n_dev} global devices)", flush=True)


if __name__ == "__main__":
    main()
