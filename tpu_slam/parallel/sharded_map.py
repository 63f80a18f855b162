"""Spatially-sharded occupancy grids: row-stripe sharding + halo exchange.

SURVEY §2.5 "spatial/model parallelism over map blocks": the reference keeps
one flat cell array (`GridMapBase.h:401`); at pod scale the grid is sharded
into row stripes over the mesh axis. Two device programs:

  * sharded log-odds update — every device rasterizes the full beam set but
    scatters only into its own stripe (out-of-stripe indices drop), so the
    combined stripes equal the unsharded update exactly, with per-device
    memory O(cells / D) and no communication at all;
  * sharded Hector GN step — bilinear interpolation at a stripe's top edge
    needs the first cell row of the next stripe: a one-row halo travels by
    `ppermute` (the ICI halo exchange), then each device accumulates H/dTr
    from the beams landing in its stripe and a `psum` forms the global
    normal equations.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tpu_slam import geometry as geo
from tpu_slam.config import GridConfig, LogOddsConfig
from tpu_slam.ops import gridmap as gm
from tpu_slam.ops.hector import interp_map_with_derivs


def make_sharded_logodds_update(
    mesh: Mesh,
    cfg: GridConfig,
    locfg: LogOddsConfig,
    max_range: float,
    axis: str = "data",
):
    """Returns f(grid (H, W) sharded over rows, origin (2,), endpoints
    (N, 2), valid (N,)) → updated sharded grid.

    Exact equivalence with ops/gridmap.logodds_update_scan: each device
    recomputes the (cheap) ray sampling and keeps only its stripe's cells.
    """
    D = mesh.shape[axis]
    assert cfg.size_y % D == 0, (cfg.size_y, D)
    rows = cfg.size_y // D

    def step(grid_stripe, origin_xy, endpoints, valid):
        me = jax.lax.axis_index(axis)
        row0 = me * rows
        free_idx, end_idx = gm.ray_cell_indices(
            cfg, origin_xy, endpoints, valid, max_range=max_range,
            stop_before_end=False,
        )

        def to_local(idx):
            r = idx // cfg.size_x
            c = idx % cfg.size_x
            ok = (r >= row0) & (r < row0 + rows) & (idx != gm.OOB_INDEX)
            return jnp.where(ok, (r - row0) * cfg.size_x + c, gm.OOB_INDEX)

        ncells = rows * cfg.size_x
        free = jnp.zeros((ncells,), bool).at[
            to_local(free_idx).reshape(-1)
        ].max(True, mode="drop")
        occ = jnp.zeros((ncells,), bool).at[
            to_local(end_idx).reshape(-1)
        ].max(True, mode="drop")
        free = free & ~occ
        lo_free, lo_occ = gm.logodds_factors(locfg, grid_stripe.dtype)
        upd = jnp.where(occ, lo_occ, jnp.where(free, lo_free, 0.0))
        flat = grid_stripe.reshape(-1) + upd
        return jnp.clip(
            flat, locfg.log_odds_min, locfg.log_odds_max
        ).reshape(rows, cfg.size_x)

    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(axis), P(), P(), P()),
            out_specs=P(axis),
        )
    )


def make_sharded_hector_step(
    mesh: Mesh,
    cfg: GridConfig,
    axis: str = "data",
    max_rot_step: float = 0.2,
    n_iters: int = 1,
):
    """Returns f(prob_grid (H, W) row-sharded, pose_map (3,), pts_map (N, 2),
    valid (N,)) → ``n_iters`` replicated GN steps (new pose_map, H (3,3)).

    Per device: ppermute halo (next stripe's first row) once, then per
    iteration local bilinear interp + H/dTr over the beams in its stripe,
    psum to assemble — the sharded ScanMatcher::matchData loop
    (ScanMatcher.h:60-139).
    """
    D = mesh.shape[axis]
    assert cfg.size_y % D == 0
    rows = cfg.size_y // D

    def step(stripe, pose_map0, pts_map, valid):
        me = jax.lax.axis_index(axis)
        row0 = me * rows
        # halo: first row of the NEXT stripe (wraps at the last device; its
        # halo row is masked out by the interpolation bounds anyway). The
        # grid is constant across GN iterations — one exchange per launch.
        perm = [((i + 1) % D, i) for i in range(D)]
        halo = jax.lax.ppermute(stripe[0:1, :], axis, perm)
        local = jnp.concatenate([stripe, halo], axis=0)  # (rows+1, W)

        def gn(pose_map):
            # transform + query in LOCAL stripe coords (cell-center
            # convention of ops/hector.hessian_derivs)
            pw = geo.apply(pose_map, pts_map) - 0.5
            y = pw[..., 1] - row0
            x = pw[..., 0]
            # the global-bounds gate (y < H−1) matches the unsharded
            # interpolation's out-of-map rejection at the top edge, where
            # the last device's wrapped halo row must not be read
            in_stripe = (
                (y >= 0.0) & (y < rows)
                & (pw[..., 1] < cfg.size_y - 1) & valid
            )
            coords = jnp.stack([x, jnp.where(in_stripe, y, 0.0)], axis=-1)
            val, dx, dy = interp_map_with_derivs(
                local.reshape(-1), cfg.size_x, rows + 1, coords
            )
            w = in_stripe.astype(pts_map.dtype)
            c = jnp.cos(pose_map[2])
            s = jnp.sin(pose_map[2])
            rot = (
                (-s * pts_map[..., 0] - c * pts_map[..., 1]) * dx
                + (c * pts_map[..., 0] - s * pts_map[..., 1]) * dy
            )
            J = jnp.stack([dx * w, dy * w, rot * w], axis=-1)
            hi = jax.lax.Precision.HIGHEST  # no TF32 (ops/hector.py)
            dTr = jax.lax.psum(
                jnp.einsum("ni,n->i", J, (1.0 - val), precision=hi), axis
            )
            H = jax.lax.psum(
                jnp.einsum("ni,nj->ij", J, J, precision=hi), axis)

            ok = (H[0, 0] != 0.0) & (H[1, 1] != 0.0)
            Hs = H + 1e-9 * jnp.eye(3, dtype=H.dtype)
            delta = jnp.linalg.solve(Hs, dTr[..., None])[..., 0]
            delta = jnp.where(jnp.isfinite(delta), delta, 0.0)
            dth = jnp.clip(delta[2], -max_rot_step, max_rot_step)
            delta = jnp.array([delta[0], delta[1], dth])
            delta = jnp.where(ok, delta, 0.0)
            return pose_map + delta, H

        if n_iters == 1:
            return gn(pose_map0)

        def body(_i, carry):
            p, _H = carry
            return gn(p)

        return jax.lax.fori_loop(
            0, n_iters, body,
            (pose_map0, jnp.zeros((3, 3), pts_map.dtype)),
        )

    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(axis), P(), P(), P()),
            out_specs=(P(), P()),
        )
    )
