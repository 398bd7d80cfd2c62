"""Feature-similarity 3D bounding-box tracker.

Port of the reference ``FeatureBasedBboxTracker`` (``vision/tracker.cpp``):
9-state constant-acceleration Kalman tracking of one target box, with data
association by feature-similarity score exp(-||normalized error||^2) over
[center, size, #points, point-stddev] features, and multi-step prediction
for irregular detection timestamps.
"""

import math
from typing import List, Optional

import numpy as np

from ..datatypes.tracking import Bbox3D, TrackedBbox3D, TrackedPose2D
from .kalman import LinearSSKalmanFilter

STATE_SIZE = 9  # (x, y, yaw, vx, vy, omega, ax, ay, a_yaw)


class FeatureBasedBboxTracker:
    def __init__(
        self,
        time_step: float,
        e_pos: float,
        e_vel: float,
        e_acc: float,
        min_accepted_similarity: float = 0.0,
    ):
        self.time_step = float(time_step)
        # default 0.0 matches the reference (tracker.h:41,
        # minAcceptedSimilarityScore_ = 0.0, never overridden): with
        # exp(-|err|^2) > 0 always, association picks the best-scoring box
        # and NEVER declares the target lost on a multi-box frame; a
        # stricter gate here silently drops the follower into its
        # wait/search state mid-run (observed in the closed-loop RGBD
        # scenario) where the reference keeps tracking
        self.min_accepted_similarity = min_accepted_similarity
        dt = self.time_step
        # constant-acceleration transition per state triplet
        # (tracker.cpp:20-24)
        A = np.eye(STATE_SIZE)
        for i in range(3):
            A[i, i + 3] = dt
            A[i, i + 6] = 0.5 * dt * dt
            A[i + 3, i + 6] = dt
        # the reference zeroes the acceleration rows' self-transition for
        # the angular acceleration only (last row all zero)
        A[8, :] = 0.0
        B = np.zeros((STATE_SIZE, 1))
        H = np.eye(STATE_SIZE)
        err = np.diag([e_pos] * 3 + [e_vel] * 3 + [e_acc] * 3)
        self._kf = LinearSSKalmanFilter(STATE_SIZE, 1)
        self._kf.setup(A, B, err, H, err)
        self._tracked: Optional[TrackedBbox3D] = None
        self._label = ""

    # --- initialization (tracker.cpp:43-95) ---

    def set_initial_tracking_box(self, box: Bbox3D, yaw: float = 0.0) -> bool:
        self._tracked = TrackedBbox3D(box=box)
        self._label = box.label
        state = np.zeros(STATE_SIZE)
        state[0] = box.center[0]
        state[1] = box.center[1]
        state[2] = yaw
        self._kf.set_initial_state(state)
        return True

    def set_initial_tracking_tracked(self, tracked: TrackedBbox3D) -> bool:
        self._tracked = tracked
        self._label = tracked.box.label
        state = np.array(
            [
                tracked.box.center[0],
                tracked.box.center[1],
                tracked.yaw(),
                tracked.vel[0],
                tracked.vel[1],
                tracked.omega(),
                tracked.acc[0],
                tracked.acc[1],
                tracked.ang_acc(),
            ]
        )
        self._kf.set_initial_state(state)
        return True

    def set_initial_tracking_point(
        self,
        pose_x_img: int,
        pose_y_img: int,
        detected_boxes: List[Bbox3D],
        yaw: float = 0.0,
    ) -> bool:
        """Pick the detected box containing the image point."""
        for box in detected_boxes:
            xl = box.get_x_limits_img()
            yl = box.get_y_limits_img()
            if xl[0] <= pose_x_img <= xl[1] and yl[0] <= pose_y_img <= yl[1]:
                return self.set_initial_tracking_box(box, yaw)
        return False

    def tracker_initialized(self) -> bool:
        return self._tracked is not None

    # --- features (tracker.cpp:192-256) ---

    @staticmethod
    def _points_std(points: np.ndarray) -> np.ndarray:
        """Point std-dev with the reference's (n-1) normalization of both
        mean and variance (tracker.cpp:238-256)."""
        n = max(len(points) - 1, 1)
        mean = points.sum(axis=0) / n
        var = ((points - mean) ** 2).sum(axis=0) / n
        return np.sqrt(var)

    def extract_features(self, box: Bbox3D) -> np.ndarray:
        f = np.zeros(9)
        f[0:2] = box.center[:2]
        f[2:5] = box.size
        f[5] = len(box.pc_points)
        if f[5] > 0:
            f[6:9] = self._points_std(np.asarray(box.pc_points))
        return f

    # --- update (tracker.cpp:119-190) ---

    def update_tracking(self, detected_boxes: List[Bbox3D]) -> bool:
        if self._tracked is None:
            # public-API guard: update before set_initial_tracking_* has
            # nothing to associate against — report "not tracking" like
            # the other None-tolerant accessors instead of crashing
            return False
        label_boxes = [b for b in detected_boxes if b.label == self._label]
        if not label_boxes:
            return False
        dt = label_boxes[0].timestamp - self._tracked.box.timestamp
        if len(label_boxes) == 1:
            # reference quirk kept verbatim (tracker.cpp:136-140): a lone
            # same-label detection is accepted unconditionally ("it is
            # the same"), bypassing the min_accepted_similarity gate
            max_score = 1.0
            found = label_boxes[0]
        else:
            predicted = self._tracked.predict_constant_acc(dt)
            ref = self.extract_features(predicted.box)
            max_score = 0.0
            found = label_boxes[0]
            for box in label_boxes:
                feats = self.extract_features(box)
                err = feats - ref
                nz = np.abs(ref) > 0.0
                err[nz] = err[nz] / np.abs(ref[nz])
                score = math.exp(-float(np.linalg.norm(err)) ** 2)
                if score > max_score:
                    max_score = score
                    found = box
        if max_score > self.min_accepted_similarity:
            dt = found.timestamp - self._tracked.box.timestamp
            number_steps = max(int(dt / self.time_step), 1)
            # a timestamp-origin mismatch (e.g. epoch-stamped detections
            # against a zero-stamped initial box) would request billions
            # of predict iterations and hang the control loop — cap the
            # covariance extrapolation (the state predict saturates long
            # before this anyway)
            if number_steps > 1000:
                import logging

                logging.getLogger("kompass_core_tpu_torch").warning(
                    "tracker dt %.3g s spans %d filter steps; capping at"
                    " 1000 (check detection timestamp origin)",
                    dt, number_steps,
                )
                number_steps = 1000
            self._tracked.update_from_new_detection(found)
            self._update_state(number_steps)
            return True
        return False

    def _update_state(self, number_steps: int):
        t = self._tracked
        measurement = np.array(
            [
                t.box.center[0],
                t.box.center[1],
                t.yaw(),
                t.vel[0],
                t.vel[1],
                t.omega(),
                t.acc[0],
                t.acc[1],
                t.ang_acc(),
            ]
        )
        self._kf.estimate(measurement, number_steps)

    # --- outputs (tracker.cpp:213-236) ---

    def get_raw_tracking(self) -> Optional[TrackedBbox3D]:
        return self._tracked

    def get_tracked_state(self) -> Optional[np.ndarray]:
        if self._tracked is not None:
            return self._kf.get_state()
        return None

    def get_filtered_tracked_pose_2d(self) -> Optional[TrackedPose2D]:
        if self._tracked is None:
            return None
        s = self._kf.get_state().flatten()
        return TrackedPose2D(
            x=float(s[0]),
            y=float(s[1]),
            yaw=float(s[2]),
            vx=float(s[3]),
            vy=float(s[4]),
            omega=float(s[5]),
        )
