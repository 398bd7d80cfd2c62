"""Device-resident fleet runtime: the whole control pipeline on the device.

Counterpart of ``kompass_core_tpu/parallel/fleet_v2.py``. Paths are
interpolated and segmented on the host once (``set_paths``), padded and
uploaded; every tick afterwards copies one packed [N, 7 + R (+ 4M)]
input matrix to the device, runs ``ops/fleet_solver`` over the whole
robot axis at once, and copies one [N, 10] output matrix back.

The robot count is padded by the JAX package's rule (a multiple of the
dispatch chunk above it; under a mesh a multiple of the mesh size, with
no chunk), so the two packages' snapshots have the same ``n`` and load
into each other; only the JAX chunk loop is gone.

``run_ticks_on_device`` runs k carry-chained ticks per call
(``ops/fleet_solver.py::make_fleet_ticks_on_device``). On a CUDA device
the k ticks are one CUDA graph, captured on the first call for each k and
replayed after: the counterpart of the JAX package's single jitted
dispatch, so the host enqueues one graph instead of k ticks' hundreds of
kernels. On the CPU the same loop runs eagerly.

With ``peer_avoidance`` every robot sees the others as obstacle discs in
its sweep, re-derived from the fleet's states every tick (inside the
k-tick loop too); with ``safety_config`` every command passes the
critical-zone emergency stop on the device. ``split_mover_sweep`` runs
the tracked movers as their own narrow sweep (K3s) beside a scan bucket
of the rays alone. A fleet with any BOX robot decides every robot's
admissibility on its oriented box (K9), a circle robot as a (0, 0) box
with its radius in its margin.

Over a ``FleetMesh`` (``parallel/multihost.py``) each shard's slice of
the path, config, carry, angle and safety tables is placed on its device
once; a tick copies each shard's input rows to its device once, runs the
fleet tick per shard (``ops/fleet_solver.py``; one state all-gather per
tick with peers, none without) and reads the outputs back in fleet row
order. Under a process group every process passes the whole fleet's
inputs and gets back its own robots' rows (``local_robots``). Without
peers the mesh's k-tick loop is row-local: on CUDA devices each shard
captures and replays the one-device loop's graph on its rows. With
peers it gathers the shards' live states every tick and runs eagerly.
"""

import dataclasses
import logging
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..datatypes.path import ReferencePath
from ..models import RobotCtrlLimits, RobotGeometry, RobotType
from ..control.dwa import DWAConfig, _round_up, segment_capacity
from ..ops.critical_zone import build_critical_zone
from ..ops.fleet_solver import (
    OUT_FIELDS,
    FleetCarry,
    FleetConfig,
    FleetPaths,
    FleetSafety,
    FleetSpec,
    build_fleet_safety,
    check_target,
    make_fleet_tick,
    make_fleet_ticks_on_device,
)
from ..ops.solver import COLLISION_MARGIN_FACTOR, SolverSpec
from ..ops.window import compute_linear_sample_split, num_angular_slots
from ..utils.cuda_graph import capture

_PAD = 1e8

logger = logging.getLogger("kompass_core_tpu_torch")


@dataclasses.dataclass(frozen=True)
class FleetSafetyConfig:
    """Critical-zone emergency-stop parameters of the safety-gated fleet
    tick (the fleet form of ``EmergencyChecker``'s constructor; reference
    ``CriticalZoneChecker`` preset, ``critical_zone_check.cpp:13-85``).
    Defaults match the reference's benchmark configuration
    (``benchmark_runner.cpp:267-311``)."""

    critical_angle_deg: float = 160.0
    critical_distance: float = 0.3
    slowdown_distance: float = 0.6


@dataclasses.dataclass
class TickGraph:
    """One captured k-tick loop: the graph, the static tensors it reads
    (``inputs``, ``carry``) and writes (``carry_out``, ``out``: the
    per-tick outputs [N, k * F] then the final states [N, 4]), and the
    tensors of the fleet it read at capture (``paths``, ``angles`` and
    the ``safety`` tables, rebuilt with the angle grid; a new tensor there
    means a new capture)."""

    graph: "torch.cuda.CUDAGraph"
    inputs: torch.Tensor
    carry: FleetCarry
    carry_out: FleetCarry
    out: torch.Tensor
    paths: FleetPaths
    angles: torch.Tensor
    safety: Optional[FleetSafety]


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
        peer_ring_points: int = 8,
        safety_config=None,  # FleetSafetyConfig, or one per robot
        tracked_obstacles: int = 0,  # M moving-object slots per robot
        peer_prediction: bool = False,  # peers advect within the rollout
        split_mover_sweep: bool = False,
        *,
        device=None,
    ):
        check_target(device, mesh, "DeviceFleet")
        self._device = None if device is None else torch.device(device)
        self.mesh = mesh
        self.num_robots = len(robots)
        self.config = config
        # the JAX package pads the robot axis to whole 64-row dispatch
        # chunks above 64 robots, and under a mesh to a multiple of the
        # mesh size alone; the same padded n keeps the two packages'
        # snapshots interchangeable (there is no chunk loop here)
        self._n = _round_up(self.num_robots, mesh.size if mesh is not None else 1)
        self._chunk = 0  # the JAX package's chunk: here it only pads
        if mesh is None and dispatch_chunk and self._n > dispatch_chunk:
            self._chunk = int(dispatch_chunk)
            self._n = _round_up(self._n, self._chunk)

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
        # collision shapes: an all-circle fleet sweeps points; any BOX robot
        # switches the whole fleet to the oriented-box field, where a circle
        # is a (0, 0) box with its radius folded into the margin (the same
        # circle model)
        has_box = any(
            r.geometry_type == RobotGeometry.Type.BOX for r in robots
        )
        margin = config.octree_resolution * COLLISION_MARGIN_FACTOR
        box2 = np.zeros((self._n, 2), np.float32)
        eff_margin = np.full(self._n, margin, np.float32)
        radius = np.zeros(self._n, np.float32)
        for i, r in enumerate(robots):
            radius[i] = r.radius
            if has_box and r.geometry_type == RobotGeometry.Type.BOX:
                gp = np.asarray(r.geometry_params, np.float64)
                box2[i] = (gp[0] / 2.0, gp[1] / 2.0)
            elif has_box:
                eff_margin[i] = r.radius + margin

        solver_spec = SolverSpec(
            is_omni=is_omni,
            n_vx=n_vx,
            n_vy=n_vy,
            n_omega=n_omega,
            max_points=int(config.prediction_horizon),
            num_ctrl_points=int(config.control_horizon),
            # tracked-mover slots share the scan bucket: they overwrite its
            # guaranteed-pad tail (ops/fleet_solver), so it holds rays + M;
            # split movers run their own sweep, and the bucket holds rays
            scan_size=max(256, _round_up(
                scan_rays + (0 if split_mover_sweep else tracked_obstacles),
                256)),
            seg_size=seg_size,
            drop_samples=bool(config.drop_samples),
            device_window=True,
            dynamic_box=has_box,
            # tracked movers and predicted peers ride the sweep at their
            # constant-velocity positions (the moving sweep); split movers
            # carry their velocities in their own sweep, so only peer
            # prediction needs the main sweep's velocity block then
            moving_obstacles=(
                (tracked_obstacles > 0 and not split_mover_sweep)
                or peer_prediction
            ),
        )
        self._tracked = int(tracked_obstacles)
        self.spec = FleetSpec(
            solver=solver_spec,
            path_capacity=path_capacity,
            max_segments=max_segments,
            tracked_obstacles=self._tracked,
            split_mover_sweep=bool(split_mover_sweep),
        )
        # fleet mutual avoidance: every robot sees the others as live
        # obstacle discs (center + circumference ring) in the same sweep
        # the scan rides; the sweep grows by N * (ring + 1) rows per robot
        self._peer_cfg = None
        if peer_prediction and not peer_avoidance:
            raise ValueError(
                "peer_prediction requires peer_avoidance=True (it "
                "advects the peer discs the avoidance path creates)"
            )
        if peer_avoidance:
            self._peer_cfg = {
                "radii": radius,  # [padded N], pads masked by n_real
                "n_real": self.num_robots,
                "ring": int(peer_ring_points),
                "predict": bool(peer_prediction),
            }
        # the emergency stop on the device: every command, each tick of
        # run_ticks_on_device included, passes the critical-zone gate
        self._safety_cfgs = None
        self._safety = None
        if safety_config is not None:
            if isinstance(safety_config, FleetSafetyConfig):
                self._safety_cfgs = [safety_config] * self.num_robots
            else:
                self._safety_cfgs = list(safety_config)
                if len(self._safety_cfgs) != self.num_robots:
                    raise ValueError(
                        "safety_config must be one FleetSafetyConfig or "
                        "one per robot"
                    )
            # the zone presets depend on the angle grid: built in
            # set_scan_angles
            self._safety_geoms = [
                (r.geometry_type.value,
                 np.asarray(r.geometry_params, np.float64))
                for r in robots
            ]
        self._tick_fn = make_fleet_tick(
            self.spec, self._device, mesh=mesh, peer_cfg=self._peer_cfg,
            safety=self._safety_cfgs is not None,
        )
        self._ticks_fns = {}  # k -> the eager k-tick loop
        self.tick_graphs = {}  # k -> TickGraph (a list of one per shard on a mesh)
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
                eff_margin[i],
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
        self._sensor_host = sensor.copy()  # the zone presets' sensor poses

        def full(value, dtype=np.float32):
            return np.full(N, value, dtype)

        self._cfg = self._put(FleetConfig(
            params12=params,
            limits9=limits_rows,
            sensor_pose=sensor,
            rotate_in_place=rotate,
            goal_dist_tol=full(config.goal_dist_tolerance),
            goal_ori_tol=full(config.goal_orientation_tolerance),
            losing_goal_dist=full(config.loosing_goal_distance),
            interp_dist=full(interp),
            base_horizon_s=full(base_h),
            curvature_tol=full(config.curvature_horizon_tolerance),
            vx_max=vx_max_rows,
            max_segment_size=full(
                int(config.path_segment_length / interp) + 1, np.int32
            ),
            collision_box2=box2,
        ))
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
    def device(self) -> Optional[torch.device]:
        """The fleet's device (None for a mesh fleet: ``mesh.devices``)."""
        return self._device

    @property
    def local_robots(self) -> range:
        """The robots whose rows this process holds and whose outputs
        ``tick`` and ``run_ticks_on_device`` return (every robot but under
        a process group)."""
        if self.mesh is None:
            return range(self.num_robots)
        rows = self.mesh.local_rows(self._n)
        return range(min(rows.start, self.num_robots),
                     min(rows.stop, self.num_robots))

    def _put(self, value):
        """The whole fleet's rows (an array, a CPU tensor or a NamedTuple of
        them) as tensors of their own on the fleet's device (a copy: later
        in-place row updates never reach the caller's array); under a mesh
        this process's rows, one value per local shard on its device."""
        if self.mesh is not None:
            return self.mesh.place(value)
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            return type(value)(*(None if a is None else self._put(a) for a in value))
        if isinstance(value, torch.Tensor):
            return value.to(self._device, copy=True)
        return torch.tensor(np.asarray(value), device=self._device)

    def _host(self, value) -> np.ndarray:
        """A placed tensor's rows (this process's), on the host."""
        if self.mesh is not None:
            return self.mesh.host_rows(value)
        return value.cpu().numpy()

    def _fields(self, tree):
        """A placed NamedTuple's fields as host arrays, in field order."""
        if self.mesh is None:
            return [self._host(t) for t in tree]
        return [self._host([shard[i] for shard in tree])
                for i in range(len(tree[0]))]

    def set_scan_angles(self, angles: np.ndarray):
        """Upload the (usually static) scan angle grid once: [R] for every
        robot, or [num_robots, R]. With a ``safety_config``, also (re)build
        the per-robot critical-zone presets: the cone masks are per beam,
        so they live and die with the angle grid."""
        ang = np.asarray(angles, np.float32)
        self._angles_src = ang.copy()
        if ang.ndim == 1:
            ang = np.tile(ang, (self._n, 1))
        else:
            a2 = np.zeros((self._n, self._scan_rays), np.float32)
            a2[: len(ang)] = ang
            ang = a2
        self._angles = self._put(ang)
        if self._safety_cfgs is not None:
            specs = []
            for i, (shape, dims) in enumerate(self._safety_geoms):
                c = self._safety_cfgs[i]
                sx, sy, syaw = (float(v) for v in self._sensor_host[i])
                specs.append(build_critical_zone(
                    robot_shape_type=shape,
                    robot_dimensions=dims,
                    sensor_position_body=(sx, sy, 0.0),
                    sensor_rotation_body=(
                        0.0, 0.0, math.sin(syaw / 2.0), math.cos(syaw / 2.0)
                    ),
                    critical_angle_deg=c.critical_angle_deg,
                    critical_distance=c.critical_distance,
                    slowdown_distance=c.slowdown_distance,
                    angles=np.asarray(ang[i], np.float64),
                ))
            self._safety = self._put(build_fleet_safety(
                specs, self._n, self._scan_rays, "cpu"))

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
        self._paths = self._put(FleetPaths(
            x, y, arc, curv, n_points, seg_starts, n_segs, total))
        self._carry = self._put(FleetCarry(
            closest_idx=np.zeros(N, np.int32),
            seg_idx=np.zeros(N, np.int32),
            pos_in_seg=np.full(N, -1.0, np.float32),
            goal_dist=np.full(N, np.inf, np.float32),
            reached=np.array(
                [False] * self.num_robots + [True] * (N - self.num_robots)
            ),
        ))

    def update_path(self, i: int, pts):
        """Re-route ONE robot mid-mission: write its new path row and reset
        ONLY its follower carry, in place on the device; every other
        robot's tracking state is untouched. Under a mesh only the shard
        that holds robot i is written (in another process's shard, none
        here)."""
        if self._paths is None:
            raise ValueError("update_path before set_paths")
        if not 0 <= i < self.num_robots:
            raise IndexError(f"robot index {i} out of range")
        row = self._path_row(pts, i)
        paths, carry, r = self._paths, self._carry, i
        if self.mesh is not None:
            n_loc = self.mesh.rows_per_shard(self._n)
            d = i // n_loc - self.mesh.shard_index(0)
            if not 0 <= d < len(self.mesh.devices):
                return
            paths, carry, r = self._paths[d], self._carry[d], i % n_loc
        for field, value in zip(paths, row):
            field[r] = torch.as_tensor(value)
        for field, value in zip(carry, (0, 0, -1.0, np.inf, False)):
            field[r] = value

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

    def tick_example_args(self):
        """The tick program's arguments ``(paths, cfg, carry, angles,
        inputs[, safety])``, as ``tick`` passes them: the fleet's device
        tensors and the packed input matrix as it stands, copied to the
        device. ``serving.export_fleet_tick`` traces the program on them
        (only their shapes and dtypes go into the artifact). Requires
        ``set_paths`` and ``set_scan_angles``: the path tables and the
        angle grid pin the artifact's static shapes."""
        if self._paths is None or self._carry is None:
            raise RuntimeError(
                "call set_paths() first — the path tables define the "
                "artifact's shapes"
            )
        if self._angles is None:
            raise RuntimeError("call set_scan_angles() first")
        extra = (self._safety,) if self._safety is not None else ()
        return (
            self._paths, self._cfg, self._carry, self._angles,
            self._put(self._inputs), *extra,
        )

    def state_dict(self) -> dict:
        """Host snapshot of the fleet's mutable state (path tables,
        follower carry, scan-angle grid) as a flat dict of numpy arrays,
        in the JAX ``DeviceFleet``'s format (version 1, the same keys and
        dtypes), so either package resumes the other's snapshot."""
        if self._paths is None or self._carry is None:
            raise RuntimeError("nothing to snapshot: call set_paths() first")
        self._refuse_multiprocess("state_dict")
        sd = {
            "version": np.int32(1),
            "n": np.int32(self._n),
            "num_robots": np.int32(self.num_robots),
            "scan_rays": np.int32(self._scan_rays),
        }
        for name, cls, tree in (("paths", FleetPaths, self._paths),
                                ("carry", FleetCarry, self._carry)):
            for field, val in zip(cls._fields, self._fields(tree)):
                sd[f"{name}/{field}"] = val.copy()
        if self._angles_src is not None:
            sd["angles_src"] = self._angles_src.copy()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore a ``state_dict`` snapshot (of either package) into a
        fleet built with the same construction parameters."""
        if int(sd["version"]) != 1:
            raise ValueError(f"unknown fleet state version {sd['version']}")
        self._refuse_multiprocess("load_state_dict")
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
        self._paths = self._put(FleetPaths(*(
            sd[f"paths/{f}"] for f in FleetPaths._fields)))
        self._carry = self._put(FleetCarry(*(
            sd[f"carry/{f}"] for f in FleetCarry._fields)))

    def _refuse_multiprocess(self, what):
        if self.mesh is not None and self.mesh.multiprocess:
            raise ValueError(
                f"{what} of a fleet sharded over processes: each process "
                "holds only its own rows; snapshot a fleet of one process"
            )

    def _prepare_tick_inputs(self, states, vels, ranges, angles, tracked):
        """Per-tick host assembly: (re)upload the angle grid when it
        actually changes, and fill the packed input matrix in place.
        Returns the tick programs' trailing safety argument, if any."""
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
        return (self._safety,) if self._safety is not None else ()

    def ticks_fn(self, k: int):
        """The fleet's eager k-tick loop (``make_fleet_ticks_on_device``),
        built once per k."""
        if k not in self._ticks_fns:
            self._ticks_fns[k] = make_fleet_ticks_on_device(
                self.spec, k, self._device, mesh=self.mesh,
                peer_cfg=self._peer_cfg, safety=self._safety_cfgs is not None,
            )
        return self._ticks_fns[k]

    def _graphed(self) -> bool:
        """Whether ``run_ticks_on_device`` replays CUDA graphs: on a CUDA
        device, and on a mesh of CUDA devices without peers, where each
        shard's loop is row-local and replays a graph of its own. With
        peers every tick of the mesh's loop gathers the shards' states,
        and the loop runs eagerly."""
        if self.mesh is None:
            return self._device.type == "cuda"
        return (self._peer_cfg is None
                and all(d.type == "cuda" for d in self.mesh.devices))

    def _shards(self):
        """Per shard (the whole fleet on one device): its device, path,
        config, carry, angle and safety tables and its rows of the packed
        input matrix."""
        if self.mesh is None:
            return [(self._device, self._paths, self._cfg, self._carry,
                     self._angles, self._safety, slice(None))]
        n_loc = self.mesh.rows_per_shard(self._n)
        first = self.mesh.local_rows(self._n).start
        safety = self._safety or [None] * len(self.mesh.devices)
        return [(dev, self._paths[d], self._cfg[d], self._carry[d], self._angles[d],
                 safety[d], slice(first + d * n_loc, first + (d + 1) * n_loc))
                for d, dev in enumerate(self.mesh.devices)]

    def _shard_ticks_fn(self, k: int, device):
        """The one-device k-tick loop on a shard's ``device``: a mesh
        fleet without peers runs it per shard."""
        if self.mesh is None:
            return self.ticks_fn(k)
        if (k, device) not in self._ticks_fns:
            self._ticks_fns[(k, device)] = make_fleet_ticks_on_device(
                self.spec, k, device, safety=self._safety_cfgs is not None)
        return self._ticks_fns[(k, device)]

    def _capture(self, k: int, device, paths, cfg, carry, angles, safety,
                 rows) -> TickGraph:
        """Capture one shard's k-tick loop on its tensors as one CUDA graph
        on its device, after one eager warm-up run on a side stream (what
        PyTorch's graph capture requires). A capture that fails raises."""
        fn = self._shard_ticks_fn(k, device)
        inputs = torch.tensor(self._inputs[rows], device=device)
        carry = FleetCarry(*(t.clone() for t in carry))
        args = (paths, cfg, carry, angles, inputs,
                *(() if safety is None else (safety,)))

        def ticks():
            carry_out, outs, final = fn(*args)
            return carry_out, torch.cat([outs.flatten(1), final], dim=1)

        with torch.cuda.device(device):
            graph, (carry_out, out) = capture(ticks, device)
        return TickGraph(graph, inputs, carry, carry_out, out, paths, angles, safety)

    def _replay(self, k: int):
        """(carry', the [N, k * F + 4] output matrix) of one replay of the
        k-tick graph (per shard on a mesh: lists of both), captured anew
        when the fleet's path tables or angle grid (and with it the safety
        tables) are new tensors. ``tick_graphs[k]`` is the TickGraph, or
        on a mesh the list of the shards' TickGraphs."""
        shards = self._shards()
        for key, old in list(self.tick_graphs.items()):
            graphs = old if isinstance(old, list) else [old]
            if any(g.paths is not s[1] or g.angles is not s[4] or g.safety is not s[5]
                   for g, s in zip(graphs, shards)):
                del self.tick_graphs[key]  # stale: free its memory first
        if k not in self.tick_graphs:
            graphs = [self._capture(k, *shard) for shard in shards]
            self.tick_graphs[k] = graphs if self.mesh is not None else graphs[0]
        graphs = self.tick_graphs[k]
        graphs = graphs if isinstance(graphs, list) else [graphs]
        for g, shard in zip(graphs, shards):
            g.inputs.copy_(torch.from_numpy(self._inputs[shard[6]]))
            for static, value in zip(g.carry, shard[3]):
                static.copy_(value)
            g.graph.replay()
        carry = [FleetCarry(*(t.clone() for t in g.carry_out)) for g in graphs]
        if self.mesh is None:
            return carry[0], graphs[0].out
        return carry, [g.out for g in graphs]

    def run_ticks_on_device(self, k: int, states, vels, ranges, angles,
                            tracked=None):
        """K carry-chained control ticks in one call.

        The scan is frozen to world-frame obstacles at the tick-0 pose
        (static-world assumption over the k-tick span); tracked movers
        advect at their velocities; the robot state is integrated on the
        device through the same kinematic update the rollout uses,
        assuming the commands execute faithfully. With ``peer_avoidance``
        the loop is fleet-synchronous: each tick re-derives the peers'
        discs from the fleet's current states, so only the scan world is
        frozen; with a ``safety_config`` every tick is gated against the
        frozen world points from the current pose. On a CUDA device the k
        ticks run as one CUDA graph (captured on the first call for each
        k, and again after ``set_paths``, ``load_state_dict`` or a new
        angle grid); over a mesh of CUDA devices without peers each shard
        replays a graph of its own; on the CPU, and over a mesh with
        peers, they run eagerly.

        Same inputs as ``tick``. Returns the usual output dict with a
        trailing per-tick axis ([num_robots, k] per field) plus
        ``final_states`` [num_robots, 4] (``local_robots``' rows under a
        process group)."""
        t0 = time.perf_counter()
        k = int(k)
        if k < 1:
            raise ValueError(f"run_ticks_on_device needs k >= 1, got {k}")
        safety = self._prepare_tick_inputs(states, vels, ranges, angles, tracked)
        if self._graphed():
            self._carry, out = self._replay(k)
        elif self.mesh is not None:
            self._carry, outs, final = self.ticks_fn(k)(
                self._paths, self._cfg, self._carry, self._angles,
                self._put(self._inputs), *safety,
            )
            out = [torch.cat([o.flatten(1), f], dim=1) for o, f in zip(outs, final)]
        else:
            self._carry, outs, final = self.ticks_fn(k)(
                self._paths, self._cfg, self._carry, self._angles,
                torch.from_numpy(self._inputs.copy()), *safety,
            )
            out = torch.cat([outs.flatten(1), final], dim=1)
        n = len(self.local_robots)
        out_np = self._host(out)[:n]  # one copy out (per shard)
        F = len(OUT_FIELDS)
        per_tick = out_np[:, : k * F].reshape(n, k, F)
        result = {f: per_tick[:, :, i] for i, f in enumerate(OUT_FIELDS)}
        result["found"] = result["found"] > 0.5
        result["reached"] = result["reached"] > 0.5
        result["final_states"] = out_np[:, k * F:]
        self.last_tick_seconds = time.perf_counter() - t0
        return result

    def tick(self, states, vels, ranges, angles, tracked=None):
        """One fleet tick.

        states [num_robots, >=3], vels [num_robots, 3],
        ranges [num_robots, R], angles [R] or [num_robots, R].
        ``tracked`` (fleets built with ``tracked_obstacles=M``): per-robot
        moving objects as a [num_robots, M', 4] array or a sequence of
        [m_i, 4] world (x, y, vx, vy) rows; each enters the robot's sweep
        at its constant-velocity predicted position.
        Returns a dict of numpy arrays per robot (``OUT_FIELDS``; the rows
        of ``local_robots`` under a process group)."""
        t0 = time.perf_counter()
        safety = self._prepare_tick_inputs(states, vels, ranges, angles, tracked)
        inputs = self._put(self._inputs)  # one copy in (per shard)
        self._carry, out_mat = self._tick_fn(
            self._paths, self._cfg, self._carry, self._angles, inputs, *safety
        )
        out_np = self._host(out_mat)[: len(self.local_robots)]  # one copy out
        out = {k: out_np[:, i] for i, k in enumerate(OUT_FIELDS)}
        out["found"] = out["found"] > 0.5
        out["reached"] = out["reached"] > 0.5
        self.last_tick_seconds = time.perf_counter() - t0
        return out
