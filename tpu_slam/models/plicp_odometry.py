"""PL-ICP keyframe laser odometry.

Re-design of lesson3's `ScanMatchPLICP` odometry node
(`lesson3/src/plicp_odometry.cc:191-517`):

  * constant-velocity motion prediction        (:442-456 GetPrediction)
  * laser↔base↔odom frame bookkeeping          (:356-370)
  * PL-ICP match against the current keyframe  (:391 sm_icp → ops/plicp.py)
  * keyframe policy: trans > kf_dist_linear ∥ rot > kf_dist_angular ∥
    every kf_scan_count scans                  (:498-517 NewKeyframeNeeded)

Architecture split (SURVEY §7 hard part b): the matcher is one jitted
fixed-shape device program; the data-dependent keyframe switching and
velocity bookkeeping run on host between steps. Also provides the batched
matcher used for data-parallel throughput benchmarking.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam import geometry as geo
from tpu_slam.config import SLAMConfig
from tpu_slam.data.scan import Scan, index_scan
from tpu_slam.ops.plicp import PLICPResult, plicp_match


class PLICPOdometry:
    """Sequential odometry over a scan stream.

    base_to_laser: pose of the laser in the base frame (the reference's
    GetBaseToLaserTf TF lookup, plicp_odometry.cc:257-283).
    """

    def __init__(self, cfg: SLAMConfig, base_to_laser=(0.0, 0.0, 0.0)):
        self.cfg = cfg
        self.base_to_laser = jnp.asarray(base_to_laser, dtype=jnp.float32)
        self.laser_to_base = geo.inverse(self.base_to_laser)
        self._match = jax.jit(
            functools.partial(plicp_match, cfg=cfg.plicp)
        )
        self.reset()

    def reset(self):
        self._kf_pts = None  # keyframe scan points (laser frame)
        self._kf_valid = None
        self._kf_base_in_odom = jnp.zeros(3, dtype=jnp.float32)
        self.base_in_odom = jnp.zeros(3, dtype=jnp.float32)
        self._last_base_in_odom = jnp.zeros(3, dtype=jnp.float32)
        self._velocity = np.zeros(3)
        self._scan_count = 0
        self._last_stamp = None

    def _new_keyframe_needed(self, d_base: np.ndarray) -> bool:
        """NewKeyframeNeeded (plicp_odometry.cc:498-517) — exact order:
        angular test, scan-count test (with reset), then linear test."""
        kf = self.cfg.keyframe
        self._scan_count += 1
        if abs(d_base[2]) > kf.kf_dist_angular:
            return True
        if self._scan_count == kf.kf_scan_count:
            self._scan_count = 0
            return True
        if d_base[0] ** 2 + d_base[1] ** 2 > kf.kf_dist_linear**2:
            return True
        return False

    def step(self, scan: Scan) -> np.ndarray:
        """Process one scan; returns the base pose in odom frame (3,)."""
        pts = scan.points()
        valid = scan.valid
        stamp = float(scan.stamp)

        if self._kf_pts is None:  # first scan becomes the keyframe (:237-292)
            self._kf_pts, self._kf_valid = pts, valid
            self._last_stamp = stamp
            return np.asarray(self.base_in_odom)

        dt = max(stamp - self._last_stamp, 1e-6)
        # constant-velocity prediction in the base frame (:442-456)
        pred_change = jnp.asarray(self._velocity * dt, dtype=jnp.float32)
        predicted_base = geo.compose(self.base_in_odom, pred_change)
        # first guess: keyframe→predicted change, expressed in laser frame
        # (:356-370 tf chain base_to_laser⁻¹ ∘ Δbase ∘ base_to_laser)
        d_base_pred = geo.relative(self._kf_base_in_odom, predicted_base)
        guess_l = geo.compose(
            self.laser_to_base, geo.compose(d_base_pred, self.base_to_laser)
        )

        res: PLICPResult = self._match(
            pts, valid, self._kf_pts, self._kf_valid, init_pose=guess_l
        )
        # match-failure fallback: keep the constant-velocity prediction
        # (the reference warns "not Converged" and publishes the unchanged
        # transform, plicp_odometry.cc:412-418)
        # CSM bounds the plausible displacement between scans by
        # max_angular_correction_deg / max_linear_correction (sm_params,
        # plicp_odometry.cc:71-77); with an exhaustive NN there is no search
        # window to bound, so the capability maps to a validity gate on the
        # final correction.
        pose_np = np.asarray(res.pose)
        pcfg = self.cfg.plicp
        within_bounds = float(
            np.hypot(pose_np[0], pose_np[1])
        ) <= pcfg.max_linear_correction and abs(float(pose_np[2])) <= math.radians(
            pcfg.max_angular_correction_deg
        )
        match_ok = (
            int(res.num_inliers) >= 10
            and bool(np.isfinite(pose_np).all())
            and within_bounds
        )
        d_laser = res.pose if match_ok else guess_l
        # corr_ch = base_to_laser ∘ d_laser ∘ laser_to_base (:406)
        d_base = geo.compose(
            self.base_to_laser, geo.compose(d_laser, self.laser_to_base)
        )
        new_base = geo.compose(self._kf_base_in_odom, d_base)

        # velocity estimate from the realized motion (latest_velocity_ :467)
        step_d = np.array(geo.relative(self.base_in_odom, new_base))
        step_d[2] = np.arctan2(np.sin(step_d[2]), np.cos(step_d[2]))
        self._velocity = step_d / dt

        self._last_base_in_odom = self.base_in_odom
        self.base_in_odom = new_base
        self._last_stamp = stamp

        if self._new_keyframe_needed(np.asarray(d_base)):
            self._kf_pts, self._kf_valid = pts, valid
            self._kf_base_in_odom = new_base  # (:423-433 keyframe swap)
        return np.asarray(new_base)

    def run(self, scans: Scan) -> np.ndarray:
        """Replay a (T, N) scan batch; returns trajectory (T, 3)."""
        T = scans.ranges.shape[0]
        out = np.zeros((T, 3))
        for t in range(T):
            out[t] = self.step(index_scan(scans, t))
        return out


def plicp_match_batch(cfg: SLAMConfig):
    """Jitted batched matcher: (B,N,2)×(B,N) pairs → B poses.

    The data-parallel form used for throughput (SURVEY §2.5): B independent
    scan-pair matches per device program.
    """
    f = functools.partial(plicp_match, cfg=cfg.plicp)
    return jax.jit(jax.vmap(lambda sp, sv, tp, tv, ip: f(sp, sv, tp, tv, init_pose=ip)))
