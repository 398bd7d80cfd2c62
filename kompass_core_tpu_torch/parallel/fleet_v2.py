"""Device-resident fleet runtime: the whole control pipeline on the device.

Counterpart of ``kompass_core_tpu/parallel/fleet_v2.py``. Paths are
interpolated and segmented on the host once (``set_paths``), padded and
uploaded; every tick afterwards copies one packed [N, 7 + R (+ 4M)]
input matrix to the device, runs ``ops/fleet_solver`` over the whole
robot axis at once, and copies one [N, 10] output matrix back.

The robot count is padded by the JAX package's rule (a multiple of the
dispatch chunk above it), so the two packages' snapshots have the same
``n`` and load into each other; only the JAX chunk loop is gone.

Not ported yet (raise ``NotImplementedError`` naming their ROADMAP item):
``run_ticks_on_device``, peer avoidance and prediction, the safety gate,
the split mover sweep, BOX robots and the mesh.
"""

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from kompass_core_tpu.datatypes.path import ReferencePath
from kompass_core_tpu.models import RobotCtrlLimits, RobotGeometry, RobotType

from ..control.dwa import DWAConfig, _round_up, segment_capacity
from ..ops.fleet_solver import (
    OUT_FIELDS,
    FleetCarry,
    FleetConfig,
    FleetPaths,
    FleetSpec,
    _not_ported,
    make_fleet_tick,
)
from ..ops.solver import COLLISION_MARGIN_FACTOR, SolverSpec
from ..ops.window import compute_linear_sample_split, num_angular_slots

_PAD = 1e8

logger = logging.getLogger("kompass_core_tpu_torch")


class DeviceFleet:
    """N robots, one on-device control pipeline on ``device``."""

    def __init__(
        self,
        robots: Sequence,
        ctrl_limits,  # RobotCtrlLimits, or one per robot
        config: DWAConfig,
        scan_rays: int,
        path_capacity: int = 2048,
        max_segments: int = 64,
        mesh=None,
        sensor_poses=None,  # [num_robots, 3] (x, y, yaw) in body, or None
        dispatch_chunk: int = 64,
        sensor_max_range: float = 10.0,
        peer_avoidance: bool = False,
        safety_config=None,
        tracked_obstacles: int = 0,  # M moving-object slots per robot
        peer_prediction: bool = False,
        split_mover_sweep: bool = False,
        *,
        device,
    ):
        if mesh is not None:
            _not_ported("DeviceFleet(mesh=...)", "5g")
        if peer_avoidance or peer_prediction:
            _not_ported("peer_avoidance and peer_prediction", "5c")
        if safety_config is not None:
            _not_ported("safety_config (the fused safety gate)", "5d")
        if split_mover_sweep:
            _not_ported("split_mover_sweep", "5e")
        if any(r.geometry_type == RobotGeometry.Type.BOX for r in robots):
            _not_ported("BOX robots in a fleet (dynamic_box)", "5f")
        self._device = torch.device(device)
        self.num_robots = len(robots)
        self.config = config
        self._n = self.num_robots
        # the JAX package pads the robot axis to whole 64-row dispatch
        # chunks above 64 robots; the same padded n keeps the two
        # packages' snapshots interchangeable (there is no chunk loop here)
        if dispatch_chunk and self._n > dispatch_chunk:
            self._n = _round_up(self._n, int(dispatch_chunk))

        # --- per-robot limits / kinematics ---
        if isinstance(ctrl_limits, RobotCtrlLimits):
            limits_list = [ctrl_limits] * self.num_robots
        else:
            limits_list = list(ctrl_limits)
            if len(limits_list) != self.num_robots:
                raise ValueError(
                    "ctrl_limits must be one RobotCtrlLimits or one per robot"
                )
        # any omni robot -> omni-shaped sample grid; non-omni robots keep
        # diff-drive sampling through zeroed vy limits
        is_omni = any(r.robot_type == RobotType.OMNI for r in robots)
        n_vx, n_vy = compute_linear_sample_split(
            is_omni, config.max_linear_samples
        )
        n_omega = num_angular_slots(config.max_angular_samples)
        dt = config.control_time_step
        base_h = config.prediction_horizon * dt
        interp = config.max_point_interpolation_distance
        fleet_vx_max = max(lim.vx_limits.max_vel for lim in limits_list)
        seg_size = segment_capacity(
            config.path_segment_length, interp, base_h, fleet_vx_max
        )
        margin = config.octree_resolution * COLLISION_MARGIN_FACTOR
        radius = np.zeros(self._n, np.float32)
        for i, r in enumerate(robots):
            radius[i] = r.radius

        solver_spec = SolverSpec(
            is_omni=is_omni,
            n_vx=n_vx,
            n_vy=n_vy,
            n_omega=n_omega,
            max_points=int(config.prediction_horizon),
            num_ctrl_points=int(config.control_horizon),
            # tracked-mover slots share the scan bucket: they overwrite its
            # guaranteed-pad tail (ops/fleet_solver), so it holds rays + M
            scan_size=max(256, _round_up(scan_rays + tracked_obstacles, 256)),
            seg_size=seg_size,
            drop_samples=bool(config.drop_samples),
            device_window=True,
            moving_obstacles=tracked_obstacles > 0,
        )
        self._tracked = int(tracked_obstacles)
        self.spec = FleetSpec(
            solver=solver_spec,
            path_capacity=path_capacity,
            max_segments=max_segments,
            tracked_obstacles=self._tracked,
        )
        self._tick_fn = make_fleet_tick(self.spec, self._device)
        self._scan_rays = scan_rays

        # per-robot config arrays
        N = self._n
        w = config.costs_weights
        limits_rows = np.zeros((N, 9), np.float32)
        params = np.zeros((N, 12), np.float32)
        vx_max_rows = np.zeros(N, np.float32)
        for i in range(N):
            lim = limits_list[min(i, self.num_robots - 1)]
            row = lim.to_array().astype(np.float32).copy()
            robot_i = robots[min(i, self.num_robots - 1)]
            if robot_i.robot_type != RobotType.OMNI:
                # non-holonomic: vy limits discarded
                # (trajectory_sampler.cpp:51-54)
                row[3:6] = 0.0
            limits_rows[i] = row
            vx_max_rows[i] = lim.vx_limits.max_vel
            params[i] = (
                dt,
                radius[i],
                margin,
                w.reference_path_distance_weight,
                w.goal_distance_weight,
                w.obstacles_distance_weight,
                w.smoothness_weight,
                w.jerk_weight,
                row[1],
                row[4],
                row[7],
                # maxObstaclesDist = sensor range / 3, the single-robot
                # controller's rule (cost_evaluator.h:174-193)
                float(sensor_max_range) / 3.0,
            )
        rotate = np.array(
            [r.robot_type != RobotType.ACKERMANN for r in robots]
            + [False] * (N - self.num_robots)
        )
        sensor = np.zeros((N, 3), np.float32)
        if sensor_poses is not None:
            sp = np.asarray(sensor_poses, np.float32)
            sensor[: len(sp)] = sp

        def full(value, dtype=torch.float32):
            return torch.full((N,), value, dtype=dtype, device=self._device)

        self._cfg = FleetConfig(
            params12=self._put(params),
            limits9=self._put(limits_rows),
            sensor_pose=self._put(sensor),
            rotate_in_place=self._put(rotate),
            goal_dist_tol=full(config.goal_dist_tolerance),
            goal_ori_tol=full(config.goal_orientation_tolerance),
            losing_goal_dist=full(config.loosing_goal_distance),
            interp_dist=full(interp),
            base_horizon_s=full(base_h),
            curvature_tol=full(config.curvature_horizon_tolerance),
            vx_max=self._put(vx_max_rows),
            max_segment_size=full(
                int(config.path_segment_length / interp) + 1, torch.int32
            ),
        )
        self._paths: Optional[FleetPaths] = None
        self._carry: Optional[FleetCarry] = None
        self._angles = None  # device-resident per-robot scan angles
        self._angles_src = None  # host copy for change detection
        self._inputs = np.zeros(
            (self._n, 4 + 3 + scan_rays + 4 * self._tracked), np.float32
        )
        if self._tracked:
            self._reset_tracked_block()
        self.last_tick_seconds = 0.0

    @property
    def device(self) -> torch.device:
        return self._device

    def _put(self, array) -> torch.Tensor:
        """A host array as a tensor of its own on the fleet's device (a
        copy: later in-place row updates never reach the caller's array)."""
        return torch.tensor(np.asarray(array), device=self._device)

    def set_scan_angles(self, angles: np.ndarray):
        """Upload the (usually static) scan angle grid once: [R] for every
        robot, or [num_robots, R]."""
        ang = np.asarray(angles, np.float32)
        self._angles_src = ang.copy()
        if ang.ndim == 1:
            ang = np.tile(ang, (self._n, 1))
        else:
            a2 = np.zeros((self._n, self._scan_rays), np.float32)
            a2[: len(ang)] = ang
            ang = a2
        self._angles = self._put(ang)

    # ------------------------------------------------------------------

    def _path_row(self, pts, i):
        """Interpolate + segment ONE path on host -> padded row arrays
        (x, y, arc, curv, n_points, seg_starts, n_segs, total_len)."""
        P = self.spec.path_capacity
        cap = P + self.spec.solver.seg_size  # extra tail for window slices
        NS = self.spec.max_segments
        interp = self.config.max_point_interpolation_distance
        max_seg_pts = int(self.config.path_segment_length / interp) + 1
        x = np.full(cap, _PAD, np.float32)
        y = np.full(cap, _PAD, np.float32)
        arc = np.zeros(cap, np.float32)
        curv = np.zeros(cap, np.float32)
        seg_starts = np.zeros(NS, np.int32)
        ref = ReferencePath(np.asarray(pts))
        ref.interpolate(interp)
        ref.segment(self.config.path_segment_length, max_seg_pts)
        n = min(ref.size(), P)
        x[:n] = ref.xs[:n]
        y[:n] = ref.ys[:n]
        arc[:n] = ref.arc_lengths[:n]
        curv[:n] = ref.curvature[:n]
        starts = np.asarray(ref.segment_starts[: ref.num_segments])
        if ref.size() > P:
            # keep only segments that survive the truncation; phantom
            # starts past the kept points would make the losing-goal
            # failsafe unreachable
            logger.warning(
                "fleet path %d truncated: %d interpolated points > "
                "path_capacity %d; increase FleetSpec.path_capacity",
                i, ref.size(), P,
            )
            starts = starts[starts < n]
        if len(starts) > NS:
            logger.warning(
                "fleet path %d has %d segments > max_segments %d; the "
                "tail merges into the last device segment and the "
                "losing-goal failsafe arms early — increase "
                "FleetSpec.max_segments or path_segment_length",
                i, len(starts), NS,
            )
        ns = max(min(len(starts), NS), 1)
        seg_starts[:ns] = starts[:ns]
        seg_starts[ns:] = n  # padded starts point past the end
        # total length of the path AS LOADED (goal = last kept point)
        total = (
            ref.total_path_length()
            if ref.size() <= P
            else float(ref.arc_lengths[n - 1])
        )
        return x, y, arc, curv, n, seg_starts, ns, np.float32(total)

    def set_paths(self, paths: Sequence[np.ndarray]):
        """Interpolate + segment each path on host, pad, upload once.

        Resets the WHOLE fleet's follower carry; ``update_path`` re-routes
        one robot."""
        if len(paths) != self.num_robots:
            raise ValueError(
                f"set_paths got {len(paths)} paths for a "
                f"{self.num_robots}-robot fleet"
            )
        N = self._n
        cap = self.spec.path_capacity + self.spec.solver.seg_size
        NS = self.spec.max_segments
        x = np.full((N, cap), _PAD, np.float32)
        y = np.full((N, cap), _PAD, np.float32)
        arc = np.zeros((N, cap), np.float32)
        curv = np.zeros((N, cap), np.float32)
        n_points = np.ones(N, np.int32)
        seg_starts = np.zeros((N, NS), np.int32)
        n_segs = np.ones(N, np.int32)
        total = np.zeros(N, np.float32)
        for i, pts in enumerate(paths):
            (x[i], y[i], arc[i], curv[i], n_points[i], seg_starts[i],
             n_segs[i], total[i]) = self._path_row(pts, i)
        self._paths = FleetPaths(*(
            self._put(a)
            for a in (x, y, arc, curv, n_points, seg_starts, n_segs, total)
        ))
        self._carry = FleetCarry(
            closest_idx=self._put(np.zeros(N, np.int32)),
            seg_idx=self._put(np.zeros(N, np.int32)),
            pos_in_seg=self._put(np.full(N, -1.0, np.float32)),
            goal_dist=self._put(np.full(N, np.inf, np.float32)),
            reached=self._put(
                [False] * self.num_robots + [True] * (N - self.num_robots)
            ),
        )

    def update_path(self, i: int, pts):
        """Re-route ONE robot mid-mission: write its new path row and reset
        ONLY its follower carry, in place on the device; every other
        robot's tracking state is untouched."""
        if self._paths is None:
            raise ValueError("update_path before set_paths")
        if not 0 <= i < self.num_robots:
            raise IndexError(f"robot index {i} out of range")
        for field, value in zip(self._paths, self._path_row(pts, i)):
            field[i] = torch.as_tensor(value)
        for field, value in zip(self._carry, (0, 0, -1.0, np.inf, False)):
            field[i] = value

    def _reset_tracked_block(self):
        """Pad every tracked-object slot: position at the sentinel,
        velocity zero (a pad must not march through the workspace)."""
        M = self._tracked
        blk = self._inputs[:, -4 * M :].reshape(self._n, M, 4)
        blk[:, :, 0:2] = _PAD
        blk[:, :, 2:4] = 0.0

    def _write_tracked(self, tracked):
        """Fill the per-robot tracked-object block of the input matrix.

        ``tracked``: None (all slots empty this tick), a [num_robots, M',
        4] array, or a sequence of per-robot [m_i, 4] arrays of world
        (x, y, vx, vy) rows with m_i <= M. Rows containing any non-finite
        value are EMPTY slots: a fixed-shape array padded with np.nan is
        the way to say "robot i tracks fewer than M' objects", and a
        tracker's NaN-velocity newborn tracks are dropped instead of
        poisoning the sweep."""
        if self._tracked == 0:
            if tracked is not None:
                raise ValueError(
                    "this fleet was built with tracked_obstacles=0 — "
                    "pass tracked_obstacles=M to the DeviceFleet "
                    "constructor to enable moving-object input"
                )
            return
        self._reset_tracked_block()
        if tracked is None:
            return
        M = self._tracked
        blk = self._inputs[:, -4 * M :].reshape(self._n, M, 4)
        arr = np.asarray(tracked, np.float32) if not isinstance(
            tracked, (list, tuple)
        ) else None
        if arr is not None and arr.ndim == 2:
            # [M', 4] could mean "M' movers for one robot" or "one mover
            # per robot"
            raise ValueError(
                "2-D tracked arrays are ambiguous — pass a 3-D "
                "[num_robots, M', 4] array or a sequence of per-robot "
                "[m_i, 4] arrays"
            )
        if arr is not None and arr.ndim == 3:
            nr, mp, w = arr.shape
            if w != 4:
                raise ValueError(
                    f"tracked rows must be [m, 4] (x, y, vx, vy); got "
                    f"trailing dim {w}"
                )
            if nr > self.num_robots:
                raise ValueError(
                    f"{nr} tracked rows for {self.num_robots} robots"
                )
            if mp > M:
                raise ValueError(
                    f"{mp} tracked objects > capacity {M} "
                    "(raise tracked_obstacles)"
                )
            ok = np.isfinite(arr).all(axis=2)  # non-finite row == empty
            np.copyto(blk[:nr, :mp], arr, where=ok[:, :, None])
            return
        rows = list(tracked)
        if len(rows) > self.num_robots:
            raise ValueError(
                f"{len(rows)} tracked rows for {self.num_robots} robots"
            )
        for i, row in enumerate(rows):
            r = np.atleast_2d(np.asarray(row, np.float32))
            if r.size == 0:
                continue
            if r.shape[1] != 4:
                raise ValueError(
                    "tracked rows must be [m, 4] (x, y, vx, vy); got "
                    f"shape {r.shape} for robot {i}"
                )
            if r.shape[0] > M:
                raise ValueError(
                    f"robot {i}: {r.shape[0]} tracked objects > capacity "
                    f"{M} (raise tracked_obstacles)"
                )
            r = r[np.isfinite(r).all(axis=1)]  # non-finite row == empty slot
            blk[i, : r.shape[0]] = r

    def state_dict(self) -> dict:
        """Host snapshot of the fleet's mutable state (path tables,
        follower carry, scan-angle grid) as a flat dict of numpy arrays,
        in the JAX ``DeviceFleet``'s format (version 1, the same keys and
        dtypes), so either package resumes the other's snapshot."""
        if self._paths is None or self._carry is None:
            raise RuntimeError("nothing to snapshot: call set_paths() first")
        sd = {
            "version": np.int32(1),
            "n": np.int32(self._n),
            "num_robots": np.int32(self.num_robots),
            "scan_rays": np.int32(self._scan_rays),
        }
        for name, tree in (("paths", self._paths), ("carry", self._carry)):
            for field, val in zip(type(tree)._fields, tree):
                sd[f"{name}/{field}"] = val.cpu().numpy().copy()
        if self._angles_src is not None:
            sd["angles_src"] = self._angles_src.copy()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict`` snapshot (of either package) into a
        fleet built with the same construction parameters."""
        if int(sd["version"]) != 1:
            raise ValueError(f"unknown fleet state version {sd['version']}")
        if (
            int(sd["n"]) != self._n
            or int(sd["scan_rays"]) != self._scan_rays
            # same padded n does NOT imply same fleet: pad rows snapshot
            # with reached=True
            or int(sd["num_robots"]) != self.num_robots
        ):
            raise ValueError(
                "snapshot shape mismatch: snapshot "
                f"(robots={int(sd['num_robots'])}, n={int(sd['n'])}, "
                f"rays={int(sd['scan_rays'])}) vs fleet "
                f"(robots={self.num_robots}, n={self._n}, "
                f"rays={self._scan_rays}) — rebuild the fleet with the "
                "snapshot's construction parameters"
            )
        if "angles_src" in sd:
            self.set_scan_angles(np.asarray(sd["angles_src"]))
        self._paths = FleetPaths(*(
            self._put(sd[f"paths/{f}"]) for f in FleetPaths._fields
        ))
        self._carry = FleetCarry(*(
            self._put(sd[f"carry/{f}"]) for f in FleetCarry._fields
        ))

    def _prepare_tick_inputs(self, states, vels, ranges, angles, tracked):
        """Per-tick host assembly: (re)upload the angle grid when it
        actually changes, and fill the packed input matrix in place."""
        if self._paths is None or self._carry is None:
            raise RuntimeError(
                "call set_paths() before ticking — the fleet has no "
                "path tables or follower carry yet"
            )
        ang_in = np.asarray(angles, np.float32)
        if self._angles is None or not np.array_equal(ang_in, self._angles_src):
            self.set_scan_angles(ang_in)
        n = self.num_robots
        R = self._scan_rays
        st = np.asarray(states, np.float32)
        self._inputs[:n, : min(4, st.shape[1])] = st[:, :4]
        self._inputs[:n, 4:7] = np.asarray(vels, np.float32)
        self._inputs[:n, 7 : 7 + R] = np.asarray(ranges, np.float32)
        self._inputs[n:, 7 : 7 + R] = _PAD
        self._write_tracked(tracked)

    def run_ticks_on_device(self, k: int, states, vels, ranges, angles,
                            tracked=None):
        _not_ported("run_ticks_on_device (the k-tick loop)", "5b")

    def tick(self, states, vels, ranges, angles, tracked=None):
        """One fleet tick.

        states [num_robots, >=3], vels [num_robots, 3],
        ranges [num_robots, R], angles [R] or [num_robots, R].
        ``tracked`` (fleets built with ``tracked_obstacles=M``): per-robot
        moving objects as a [num_robots, M', 4] array or a sequence of
        [m_i, 4] world (x, y, vx, vy) rows; each enters the robot's sweep
        at its constant-velocity predicted position.
        Returns a dict of numpy arrays per robot (``OUT_FIELDS``)."""
        t0 = time.perf_counter()
        self._prepare_tick_inputs(states, vels, ranges, angles, tracked)
        inputs = torch.tensor(self._inputs, device=self._device)  # one copy in
        self._carry, out_mat = self._tick_fn(
            self._paths, self._cfg, self._carry, self._angles, inputs
        )
        out_np = out_mat[: self.num_robots].cpu().numpy()  # one copy out
        out = {k: out_np[:, i] for i, k in enumerate(OUT_FIELDS)}
        out["found"] = out["found"] > 0.5
        out["reached"] = out["reached"] > 0.5
        self.last_tick_seconds = time.perf_counter() - t0
        return out
