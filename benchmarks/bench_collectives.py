"""Collective-traffic accounting for the distributed programs.

For mesh sizes 1/2/4/8 (virtual CPU devices — the partitioned HLO is
identical to a real slice's), compiles each distributed program and counts
the collectives XLA inserted, with per-op payload bytes read from the HLO
shapes. Multiply by step rate and divide by the interconnect's bandwidth
to get the communication share of a step, without needing N real cards.

    python benchmarks/bench_collectives.py --devices 8
"""

import argparse
import os
import re
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

COLLECTIVES = ("all-reduce", "collective-permute", "all-gather",
               "reduce-scatter", "all-to-all")

_SHAPE_BYTES = {
    "f32": 4, "f64": 8, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
    "s8": 1, "u8": 1, "pred": 1, "s64": 8, "u64": 8,
}


def shape_bytes(shape_str: str) -> int:
    """'f32[8,3]{1,0}' → 96; tuples summed."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _SHAPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _SHAPE_BYTES[dt]
    return total


def collective_stats(compiled_text: str) -> dict:
    """op kind → (count, payload bytes) from optimized HLO."""
    out = {}
    for line in compiled_text.splitlines():
        s = line.strip()
        for kind in COLLECTIVES:
            # ops look like: %x = f32[..] all-reduce(...), or fusion'd
            # start/done pairs (count the -start only once)
            if re.search(rf"\b{kind}(-start)?\(", s):
                if f"{kind}-done" in s or "=" not in s:
                    continue
                # result shape(s) sit between '=' and the op name:
                # %x = (f32[..], ..) all-reduce(...)
                rhs = s.split("=", 1)[1]
                shape_part = rhs.split(kind, 1)[0]
                n, b = out.get(kind, (0, 0))
                out[kind] = (n + 1, b + shape_bytes(shape_part))
                break
    return out


def report(name, lowered):
    txt = lowered.compile().as_text()
    stats = collective_stats(txt)
    if not stats:
        print(f"| {name} | none | 0 | 0 |")
        return
    for kind, (n, b) in sorted(stats.items()):
        print(f"| {name} | {kind} | {n} | {b:,} |")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    args = ap.parse_args()
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from tpu_slam.config import default_config
    from tpu_slam.parallel.mesh import make_mesh
    from tpu_slam.parallel.distributed_step import make_sharded_training_step
    from tpu_slam.parallel.loop_search import make_ring_loop_search
    from tpu_slam.solver.distributed import (
        make_distributed_cg_delta, make_distributed_lm_delta,
    )
    from tpu_slam.solver.schur import build_partition, \
        make_distributed_schur_delta

    D = args.devices
    mesh = make_mesh(D)
    cfg = default_config()
    N = -(-cfg.scan.num_beams // 128) * 128

    print(f"mesh: {D} devices; outdoor-scale shapes where applicable")
    print("| program | collective | count/step | payload bytes/step |")
    print("|---|---|---|---|")

    # 1) data-parallel batched matcher step (B = 64/device)
    B = 64 * D
    f = make_sharded_training_step(mesh, cfg)
    pts = jnp.zeros((B, N, 2), jnp.float32)
    vld = jnp.ones((B, N), bool)
    g = jnp.zeros((B, 3), jnp.float32)
    poses = jnp.zeros((B + 1, 3), jnp.float32)
    report("matcher step (B=64/dev)", jax.jit(f).lower(
        pts, vld, pts, vld, g, poses, jnp.float32(1e-4)))

    # 2) distributed LM delta — outdoor-scale graph (6144 nodes, 1.25x edges)
    M = 6144
    E = (M + M // 4 + D - 1) // D * D
    lm = make_distributed_lm_delta(mesh, M)
    argsz = (
        jnp.zeros((M, 3), jnp.float32),
        jnp.zeros((E,), jnp.int32), jnp.zeros((E,), jnp.int32),
        jnp.zeros((E, 3), jnp.float32), jnp.zeros((E, 3, 3), jnp.float32),
        jnp.ones((E,), bool), jnp.float32(1e-4),
        jnp.ones((M,), bool),
    )
    report(f"LM delta (M={M}, E={E})", jax.jit(lm).lower(*argsz))

    # 2b) PRODUCTION mesh LM loop (full doSPA while_loop, CG path at this M)
    import functools

    from jax.sharding import PartitionSpec as Pspec

    from tpu_slam.solver.pose_graph import _lm_loop_program

    body = functools.partial(
        _lm_loop_program, M=M, use_dense=False, iters=40,
        cg_iterations=100, cg_tolerance=1e-10, psum_axis="data",
        schur_part=None,
    )
    prod = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(Pspec(), Pspec(), Pspec("data"), Pspec("data"),
                  Pspec("data"), Pspec("data"), Pspec("data"), Pspec()),
        out_specs=(Pspec(), Pspec(), Pspec(), Pspec()),
    ))
    argp = (
        jnp.zeros((M, 3), jnp.float32), jnp.float32(1e-4),
        jnp.zeros((E,), jnp.int32), jnp.zeros((E,), jnp.int32),
        jnp.zeros((E, 3), jnp.float32), jnp.zeros((E, 3, 3), jnp.float32),
        jnp.ones((E,), bool), jnp.ones((M,), bool),
    )
    report(f"PRODUCTION LM loop (M={M}, CG, PER WHOLE doSPA)",
           prod.lower(*argp))

    # 3) distributed CG delta, same graph
    cg = make_distributed_cg_delta(mesh, M, cg_iters=100)
    report(f"CG delta (M={M}, 100 iters)", jax.jit(cg).lower(*argsz))

    # 4) Schur submap delta (one submap per device)
    ei = np.arange(M - 1)
    ej = np.arange(1, M)
    mask = np.ones(M - 1, bool)
    part = build_partition(ei, ej, mask, M, D)
    sd = make_distributed_schur_delta(mesh, part)
    argss = (
        jnp.zeros((M, 3), jnp.float32),
        jnp.asarray(ei), jnp.asarray(ej),
        jnp.zeros((M - 1, 3), jnp.float32),
        jnp.zeros((M - 1, 3, 3), jnp.float32),
        jnp.asarray(mask), jnp.float32(1e-4), jnp.ones((M,), bool),
    )
    report(f"Schur delta (M={M}, {D} submaps)", jax.jit(sd).lower(*argss))

    # 5) ring-pass loop search over a 8192-keyframe store
    K = 8192 // D * D
    ring = make_ring_loop_search(mesh)
    report(f"ring loop search (K={K})", jax.jit(ring).lower(
        jnp.zeros((D, 2), jnp.float32), jnp.zeros((K, 2), jnp.float32)))


if __name__ == "__main__":
    main()
