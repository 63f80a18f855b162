"""IMU + wheel-odometry motion-distortion correction.

Re-design of lesson5's `LidarUndistortion`
(`lesson5/src/lidar_undistortion.cc:96-463`). The reference walks deques with
three host threads and per-point while-loops; here the whole correction is one
vectorized device program:

  * IMU yaw-rate integration into a rotation timeline (:207-243)
    → trapezoidal cumulative sum + linear interpolation at beam times
  * odom start/end translation increment (:280-335)
    → pose interpolation at the scan window endpoints
  * per-point rotation (:398-432) / translation (:435-447) interpolation and
    transform into the first-point frame (:374-393)
    → batched SE(2) apply

Fixed shapes: IMU/odom streams are padded arrays with validity implied by
timestamps; everything jits and vmaps over scan batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tpu_slam import geometry as geo
from tpu_slam.data.scan import Scan


def integrate_imu_rotation(
    imu_stamps: jax.Array, imu_omega: jax.Array, query_times: jax.Array
) -> jax.Array:
    """Integrated yaw angle at ``query_times`` relative to the stream start.

    Trapezoidal integration of angular velocity — the vectorized form of the
    incremental rotation table of lidar_undistortion.cc:236-242.
    """
    dt = jnp.diff(imu_stamps)
    seg = 0.5 * (imu_omega[1:] + imu_omega[:-1]) * dt
    cum = jnp.concatenate([jnp.zeros_like(seg[:1]), jnp.cumsum(seg)])
    return jnp.interp(query_times, imu_stamps, cum)


def interp_pose_timeline(
    stamps: jax.Array, poses: jax.Array, query_times: jax.Array
) -> jax.Array:
    """Linear SE(2) interpolation of a pose timeline at query times.

    The odom interpolation of lidar_undistortion.cc:280-335.
    """
    x = jnp.interp(query_times, stamps, poses[:, 0])
    y = jnp.interp(query_times, stamps, poses[:, 1])
    # interpolate heading via its unit vector to survive ±pi wraps
    c = jnp.interp(query_times, stamps, jnp.cos(poses[:, 2]))
    s = jnp.interp(query_times, stamps, jnp.sin(poses[:, 2]))
    return jnp.stack([x, y, jnp.arctan2(s, c)], axis=-1)


def undistort_scan(
    scan: Scan,
    imu_stamps: jax.Array,
    imu_omega: jax.Array,
    odom_stamps: jax.Array,
    odom_poses: jax.Array,
    use_imu: bool = True,
    use_odom: bool = True,
) -> jax.Array:
    """Return corrected scan points (..., N, 2) in the first-beam frame.

    Per beam i with time t_i in the scan window [t_0, t_end]:
      rotation  dθ_i = ∫ω dt over [t_0, t_i]                 (:398-432)
      translation d_i = ratio_i · (odom(t_end) ⊖ odom(t_0)).xy (:435-447)
    corrected point = R(dθ_i)·p_i + d_i                       (:374-393)

    which expresses every point in the frame the sensor had at the first
    beam — exactly the reference's transStartInverse·transFinal composition
    with identity transStart.
    """
    bt = scan.beam_times()
    t0 = scan.stamp
    n = scan.num_beams

    if use_imu:
        base = integrate_imu_rotation(imu_stamps, imu_omega, t0[..., None])
        rot = (
            integrate_imu_rotation(imu_stamps, imu_omega, bt) - base
        )
    else:
        rot = jnp.zeros_like(bt)

    if use_odom:
        t_end = bt[..., -1]
        start = interp_pose_timeline(odom_stamps, odom_poses, t0)
        end = interp_pose_timeline(odom_stamps, odom_poses, t_end)
        inc = geo.relative(start, end)  # transBegin⁻¹·transEnd (:328-334)
        ratio = (bt - t0[..., None]) / jnp.maximum(
            (t_end - t0)[..., None], 1e-9
        )
        trans = ratio[..., None] * inc[..., None, :2]
    else:
        trans = jnp.zeros(bt.shape + (2,), dtype=scan.ranges.dtype)

    pts = scan.points()
    c, s = jnp.cos(rot), jnp.sin(rot)
    x = c * pts[..., 0] - s * pts[..., 1] + trans[..., 0]
    y = s * pts[..., 0] + c * pts[..., 1] + trans[..., 1]
    out = jnp.stack([x, y], axis=-1)
    return jnp.where(scan.valid[..., None], out, 0.0)


def undistorted_ranges(points: jax.Array, valid: jax.Array) -> jax.Array:
    """Re-derive ranges from corrected points (for republishing as a scan,
    the PublishCorrectedPointCloud analogue :450-463)."""
    r = jnp.linalg.norm(points, axis=-1)
    return jnp.where(valid, r, jnp.inf)
