"""Shared correspondence search for the ICP family.

Replacement for PCL's KD-tree correspondences
(`lesson2/src/scan_match_icp.cc:138-143`) and CSM's angular-window
correspondence tricks (`use_corr_tricks`, lesson3/src/plicp_odometry.cc:99).

At 2D-scan sizes (N ≲ 2k beams) an exhaustive pairwise search is one fused
elementwise-plus-argmin program, exact, with no "tricks" to verify.
Distances are the exact differences (x − x')² + (y − y')²: the expanded form
‖a‖² + ‖b‖² − 2a·b cancels catastrophically at a 12 m range, and a
matrix-unit cross term (TF32 on a GPU) would let the argmin pick the wrong
neighbour.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = 1e12


def pairwise_sqdist(a: jax.Array, b: jax.Array) -> jax.Array:
    """(..., N, 2) × (..., M, 2) → (..., N, M) squared distances."""
    dx = a[..., :, None, 0] - b[..., None, :, 0]
    dy = a[..., :, None, 1] - b[..., None, :, 1]
    return dx * dx + dy * dy


def nearest_neighbor(
    src: jax.Array,
    tgt: jax.Array,
    tgt_valid: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """For each src point the index and squared distance of the nearest
    valid tgt point. Shapes: src (..., N, 2), tgt (..., M, 2) → ((..., N), (..., N))."""
    d2 = pairwise_sqdist(src, tgt)
    d2 = jnp.where(tgt_valid[..., None, :], d2, BIG)
    return jnp.argmin(d2, axis=-1), jnp.min(d2, axis=-1)


def second_point_on_segment(
    idx: jax.Array, src_w: jax.Array, tgt: jax.Array, tgt_valid: jax.Array
) -> jax.Array:
    """CSM's second correspondence point: the better of the two beams adjacent
    to the nearest point j1 (csm sm/icp/icp_corr_*: j2 ∈ {j1−1, j1+1}).

    Returns indices (..., N) of j2 (clamped at scan ends; invalid neighbors
    lose by distance).
    """
    m = tgt.shape[-2]
    lo = jnp.clip(idx - 1, 0, m - 1)
    hi = jnp.clip(idx + 1, 0, m - 1)

    def d2_at(j):
        q = jnp.take_along_axis(tgt, j[..., None], axis=-2)
        v = jnp.take_along_axis(tgt_valid, j, axis=-1)
        d = jnp.sum((src_w - q) ** 2, axis=-1)
        return jnp.where(v & (j != idx), d, BIG)

    d_lo, d_hi = d2_at(lo), d2_at(hi)
    return jnp.where(d_lo <= d_hi, lo, hi)


def masked_quantile(x: jax.Array, mask: jax.Array, q: float) -> jax.Array:
    """Quantile of x over mask==True entries (per batch row, static shape).

    Used for CSM's outlier trimming percentiles (plicp_odometry.cc:139-156):
    invalid entries are pushed to +BIG, the quantile is taken at
    q·(count−1) in the sorted order via a gather.
    """
    n = x.shape[-1]
    xs = jnp.sort(jnp.where(mask, x, BIG), axis=-1)
    cnt = jnp.sum(mask, axis=-1)
    pos = jnp.clip(
        jnp.floor(q * jnp.maximum(cnt - 1, 0)).astype(jnp.int32), 0, n - 1
    )
    return jnp.take_along_axis(xs, pos[..., None], axis=-1)[..., 0]


def masked_quantiles(x: jax.Array, mask: jax.Array, qs: tuple) -> list:
    """Several masked quantiles from ONE sort (the per-round trimming needs
    two; sorting twice doubled the cost of the trim stage)."""
    n = x.shape[-1]
    xs = jnp.sort(jnp.where(mask, x, BIG), axis=-1)
    cnt = jnp.sum(mask, axis=-1)
    out = []
    for q in qs:
        pos = jnp.clip(
            jnp.floor(q * jnp.maximum(cnt - 1, 0)).astype(jnp.int32), 0, n - 1
        )
        out.append(jnp.take_along_axis(xs, pos[..., None], axis=-1)[..., 0])
    return out
