"""SE(2) geometry core.

Replacement for the reference's scattered pose math:
`karto::Pose2` / `karto::Transform` (reference `lesson6/lib/open_karto/include/
open_karto/Karto.h:1959-2950`), tf2 transform chains
(`lesson3/src/plicp_odometry.cc:356-370`), and Hector's
`Eigen::Affine2f` pose transforms (`lesson4/include/lesson4/hector_mapping/
map/GridMapBase.h:270-286`).

Poses are arrays of shape ``(..., 3)`` holding ``(x, y, theta)``; every op is
batched and jit/vmap-friendly (no data-dependent control flow, static shapes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "normalize_angle",
    "compose",
    "inverse",
    "apply",
    "relative",
    "exp",
    "log",
    "to_matrix",
    "from_matrix",
    "interpolate",
    "rot2",
]


def normalize_angle(theta: jax.Array) -> jax.Array:
    """Wrap angles to (-pi, pi].

    Mirrors `karto::math::NormalizeAngle` (Karto.h Math.h:145) and
    `util::normalize_angle` (hector util/UtilFunctions.h).
    """
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


def rot2(theta: jax.Array) -> jax.Array:
    """2x2 rotation matrices, shape (..., 2, 2)."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def compose(a: jax.Array, b: jax.Array) -> jax.Array:
    """Pose composition a ⊕ b: first apply b in a's frame.

    Equivalent to `tf2::Transform` multiplication used for the
    odom→keyframe→laser chains (plicp_odometry.cc:356-370, :406) and
    `karto::Transform::TransformPose` (Karto.h:2890-2930).
    """
    ax, ay, at = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bt = b[..., 0], b[..., 1], b[..., 2]
    c, s = jnp.cos(at), jnp.sin(at)
    return jnp.stack(
        [
            ax + c * bx - s * by,
            ay + s * bx + c * by,
            normalize_angle(at + bt),
        ],
        axis=-1,
    )


def inverse(a: jax.Array) -> jax.Array:
    """Pose inverse: compose(inverse(a), a) == identity."""
    ax, ay, at = a[..., 0], a[..., 1], a[..., 2]
    c, s = jnp.cos(at), jnp.sin(at)
    return jnp.stack(
        [-(c * ax + s * ay), -(-s * ax + c * ay), normalize_angle(-at)],
        axis=-1,
    )


def relative(a: jax.Array, b: jax.Array) -> jax.Array:
    """b expressed in a's frame: compose(inverse(a), b)."""
    return compose(inverse(a), b)


def apply(pose: jax.Array, points: jax.Array) -> jax.Array:
    """Transform points (..., N, 2) by pose (..., 3).

    The world-point computation of `LocalizedRangeScan::Update`
    (Karto.h:5398-5440) and Hector's `transform * currPoint`
    (OccGridMapUtil.h:~100).
    """
    t = pose[..., 2]
    c, s = jnp.cos(t), jnp.sin(t)
    x, y = points[..., 0], points[..., 1]
    px = pose[..., 0]
    py = pose[..., 1]
    if points.ndim > pose.ndim - 1 + 1:  # points has an extra N axis vs pose
        c, s = c[..., None], s[..., None]
        px, py = px[..., None], py[..., None]
    return jnp.stack([c * x - s * y + px, s * x + c * y + py], axis=-1)


@jax.jit
def compose_chain(pose0: jax.Array, rels: jax.Array) -> jax.Array:
    """Integrate a chain of relative poses: returns (T, 3) absolute poses
    with ``out[0] = pose0`` and ``out[k+1] = out[k] ⊕ rels[k]``.

    SE(2) composition is associative, so the whole chain integrates in one
    `lax.associative_scan` (log-depth on device) instead of the reference's
    sequential TF accumulation (plicp_odometry.cc:406-470) — the batched
    building block of the offline mapper. Angles are carried as (cos, sin)
    so the scan's combine is algebraic; headings are re-extracted at the
    end, which also renormalizes any drift in the rotation magnitude.
    """
    first = pose0[None]
    seq = jnp.concatenate([first, rels], axis=0)  # (T, 3)
    c = jnp.cos(seq[:, 2])
    s = jnp.sin(seq[:, 2])
    el = jnp.stack([c, s, seq[:, 0], seq[:, 1]], axis=-1)  # (T, 4)

    def comb(a, b):
        ca, sa, xa, ya = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        cb, sb, xb, yb = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return jnp.stack(
            [
                ca * cb - sa * sb,
                sa * cb + ca * sb,
                xa + ca * xb - sa * yb,
                ya + sa * xb + ca * yb,
            ],
            axis=-1,
        )

    acc = jax.lax.associative_scan(comb, el, axis=0)
    return jnp.stack(
        [acc[:, 2], acc[:, 3], jnp.arctan2(acc[:, 1], acc[:, 0])], axis=-1
    )


def exp(v: jax.Array) -> jax.Array:
    """SE(2) exponential map from twist (vx, vy, omega) to pose."""
    vx, vy, w = v[..., 0], v[..., 1], v[..., 2]
    small = jnp.abs(w) < 1e-6
    w_safe = jnp.where(small, 1.0, w)
    sw, cw = jnp.sin(w_safe), jnp.cos(w_safe)
    a = jnp.where(small, 1.0 - w * w / 6.0, sw / w_safe)
    b = jnp.where(small, w / 2.0, (1.0 - cw) / w_safe)
    return jnp.stack(
        [a * vx - b * vy, b * vx + a * vy, normalize_angle(w)], axis=-1
    )


def log(p: jax.Array) -> jax.Array:
    """SE(2) logarithm map, inverse of :func:`exp`."""
    x, y, t = p[..., 0], p[..., 1], normalize_angle(p[..., 2])
    small = jnp.abs(t) < 1e-6
    t_safe = jnp.where(small, 1.0, t)
    half = t_safe / 2.0
    cot = half / jnp.tan(half)
    a = jnp.where(small, 1.0 - t * t / 12.0, cot)
    b = jnp.where(small, t / 2.0, half)
    return jnp.stack([a * x + b * y, -b * x + a * y, t], axis=-1)


def to_matrix(pose: jax.Array) -> jax.Array:
    """Pose to 3x3 homogeneous matrix, shape (..., 3, 3)."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    zero = jnp.zeros_like(c)
    one = jnp.ones_like(c)
    row0 = jnp.stack([c, -s, pose[..., 0]], axis=-1)
    row1 = jnp.stack([s, c, pose[..., 1]], axis=-1)
    row2 = jnp.stack([zero, zero, one], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def from_matrix(m: jax.Array) -> jax.Array:
    """3x3 homogeneous matrix to pose."""
    return jnp.stack(
        [m[..., 0, 2], m[..., 1, 2], jnp.arctan2(m[..., 1, 0], m[..., 0, 0])],
        axis=-1,
    )


def interpolate(a: jax.Array, b: jax.Array, alpha: jax.Array) -> jax.Array:
    """Linear pose interpolation with shortest-path angle blending.

    The per-point interpolation of lesson5's undistortion
    (`lesson5/src/lidar_undistortion.cc:398-447`): translation lerped,
    rotation slerped along the angle difference.
    """
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    dt = normalize_angle(b[..., 2] - a[..., 2])
    return jnp.stack(
        [
            a[..., 0] + alpha * dx,
            a[..., 1] + alpha * dy,
            normalize_angle(a[..., 2] + alpha * dt),
        ],
        axis=-1,
    )
