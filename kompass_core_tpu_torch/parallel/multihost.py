"""Scale-out: the device mesh, the multi-process start-up and the fleet
control runtime.

Counterpart of ``kompass_core_tpu/parallel/multihost.py``. The JAX
package shards the robot axis over a ``jax.sharding.Mesh`` that spans
every chip of every process; here the mesh is explicit.

The mesh (``FleetMesh``):

* ``devices`` are this process's shards, in order: a list of
  ``torch.device``, the same device allowed more than once (two shards on
  one card run one after the other). There is no "every visible card"
  default: the caller names each shard's device.
* An optional ``torch.distributed`` process group joins the processes;
  every process in it holds the same number of shards. Shard ``d`` of
  process ``r`` is global shard ``r * len(devices) + d``, and ``size`` is
  the global shard count (the JAX mesh's ``mesh.shape[axis_name]``).
* A sharded value is a list with one entry per local shard, each on its
  shard's device. ``split`` cuts this process's rows into it, ``place``
  first takes this process's rows out of the whole fleet's, and
  ``host_rows`` copies the shards' rows back to one host array.
* The one collective of the fleet's steady state is
  ``all_gather_rows``: the shards' blocks joined in global row order on
  every shard's device (``torch.cat`` within the process, then
  ``dist.all_gather`` across processes). The sample-parallel solve's
  combine is ``all_reduce`` (min, then a sum). Each call adds one to
  ``collectives[name]``: the counts the JAX package reads off its
  compiled programs' HLO text.
* The backend is the caller's: a gloo group sends each gathered block
  through the host, an NCCL group keeps it on the cards. Nothing picks a
  backend by probing for a card.

``FleetRuntime`` is the JAX package's host-follower runtime on the port's
``DWA``: one controller per robot for the host-side state, one fleet
solve per tick on a device or a mesh, one re-dispatch on a failure and a
safe stop after a second.
"""

import concurrent.futures
import dataclasses
import logging
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..control.dwa import DWA, _round_up
from ..models import Robot, RobotCtrlLimits, RobotState
from ..native import segment_block
from ..ops.fleet_solver import check_target
from ..ops.solver import pack_solver_input, packed_input_size, unpack_solver_output
from .fleet import make_fleet_solver


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to the fleet's process group (a no-op for one
    process): ``torch.distributed.init_process_group`` over
    ``tcp://<coordinator_address>`` (``host:port``) with ``backend``,
    ``"gloo"`` (through the host) or ``"nccl"`` (card to card), which the
    caller chooses. Afterwards ``build_fleet_mesh`` takes the group."""
    if num_processes is None or num_processes <= 1:
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(
            f"backend must be 'gloo' or 'nccl', got {backend!r}: the caller "
            "chooses it (gloo through the host, NCCL card to card)"
        )
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class FleetMesh:
    """The robot axis sharded over ``devices`` (this process's shards) and,
    with ``group``, over the processes of a ``torch.distributed`` group."""

    def __init__(self, devices: Sequence, group=None, axis_name: str = "robots"):
        if devices is None or len(devices) == 0:
            raise ValueError("a fleet mesh needs at least one device")
        self.devices = tuple(_device(d) for d in devices)
        self.axis_name = axis_name
        self.group = group
        self.process_count = 1 if group is None else dist.get_world_size(group)
        self.process_index = 0 if group is None else dist.get_rank(group)
        self.size = self.process_count * len(self.devices)
        self._through_host = (group is not None
                              and dist.get_backend(group) == "gloo")
        self.collectives = {"all_gather": 0, "all_reduce": 0}

    def __repr__(self) -> str:
        return (f"FleetMesh({self.axis_name}: {len(self.devices)} shards x "
                f"{self.process_count} processes on {list(self.devices)})")

    @property
    def multiprocess(self) -> bool:
        return self.process_count > 1

    def shard_index(self, d: int) -> int:
        """The global index of local shard ``d``."""
        return self.process_index * len(self.devices) + d

    def rows_per_shard(self, n_rows: int) -> int:
        """Each shard's rows of an ``n_rows``-row fleet (every shard holds
        the same count, the JAX ``shard_map`` contract)."""
        if n_rows % self.size:
            raise ValueError(
                f"{n_rows} fleet rows do not divide over {self.size} shards: "
                "pad the robot axis to a multiple of the mesh size"
            )
        return n_rows // self.size

    def row_ids(self, d: int, n_rows: int) -> np.ndarray:
        """The global rows of local shard ``d`` in an ``n_rows``-row fleet."""
        n_loc = self.rows_per_shard(n_rows)
        return self.shard_index(d) * n_loc + np.arange(n_loc)

    def local_rows(self, n_rows: int) -> slice:
        """This process's rows of an ``n_rows``-row fleet."""
        n_proc = self.rows_per_shard(n_rows) * len(self.devices)
        return slice(self.process_index * n_proc, (self.process_index + 1) * n_proc)

    def split(self, x) -> list:
        """This process's rows (an array or tensor, or a NamedTuple of them;
        ``None`` leaves stay ``None``) -> one value per local shard, each a
        copy of its rows on its device."""
        if x is None:
            return [None] * len(self.devices)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            fields = [self.split(leaf) for leaf in x]
            return [type(x)(*(f[d] for f in fields)) for d in range(len(self.devices))]
        n = x.shape[0]
        if n % len(self.devices):
            raise ValueError(
                f"{n} rows do not divide over this process's "
                f"{len(self.devices)} shards"
            )
        n_loc = n // len(self.devices)
        out = []
        for d, dev in enumerate(self.devices):
            rows = x[d * n_loc:(d + 1) * n_loc]
            if isinstance(rows, torch.Tensor):
                out.append(rows.to(dev, copy=True))
            else:
                out.append(torch.tensor(np.asarray(rows), device=dev))
        return out

    def place(self, x) -> list:
        """The whole fleet's rows -> this process's rows, split per shard."""
        if x is None:
            return self.split(None)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            rows = self.local_rows(next(a for a in x if a is not None).shape[0])
            return self.split(type(x)(*(None if a is None else a[rows] for a in x)))
        return self.split(x[self.local_rows(x.shape[0])])

    @staticmethod
    def host_rows(parts) -> np.ndarray:
        """The local shards' rows, in row order, as one host array (one
        copy per shard)."""
        return np.concatenate([p.cpu().numpy() for p in parts], axis=0)

    def _per_device(self, value) -> list:
        """``value`` on every local shard's device (one copy per device)."""
        copies = {value.device: value}
        out = []
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = value.to(dev)
            out.append(copies[dev])
        return out

    def _across_processes(self, value, collective):
        """Run ``collective(tensor)`` over the group: through the host for
        gloo, on the device for NCCL; returns the result on ``value``'s
        device."""
        home = value.device
        send = value.cpu() if self._through_host else value.contiguous()
        out = collective(send)
        return out.to(home)

    def all_gather_rows(self, blocks) -> list:
        """One [n_loc, c] block per local shard -> the [n_loc * size, c]
        gather in global row order, on every local shard's device."""
        if len(blocks) != len(self.devices):
            raise ValueError(
                f"{len(blocks)} blocks for {len(self.devices)} local shards")
        self.collectives["all_gather"] += 1
        home = blocks[0].device
        joined = torch.cat([b.to(home) for b in blocks])
        if self.multiprocess:
            def gather(t):
                parts = [torch.empty_like(t) for _ in range(self.process_count)]
                dist.all_gather(parts, t, group=self.group)
                return torch.cat(parts)

            joined = self._across_processes(joined, gather)
        return self._per_device(joined)

    def all_reduce(self, values, op: str) -> list:
        """One tensor per local shard (the same shape) -> their ``"min"`` or
        ``"sum"`` over every shard of the mesh, on every local shard's
        device. The sum adds the shards in order, so one shard is returned
        as it is."""
        if len(values) != len(self.devices):
            raise ValueError(
                f"{len(values)} values for {len(self.devices)} local shards")
        combine = {"min": torch.minimum, "sum": torch.add}[op]
        self.collectives["all_reduce"] += 1
        home = values[0].device
        acc = values[0]
        for v in values[1:]:
            acc = combine(acc, v.to(home))
        if self.multiprocess:
            reduce_op = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}[op]

            def reduce(t):
                t = t.clone()
                dist.all_reduce(t, op=reduce_op, group=self.group)
                return t

            acc = self._across_processes(acc, reduce)
        return self._per_device(acc)


def build_fleet_mesh(devices, group=None, axis_name: str = "robots") -> FleetMesh:
    """The fleet mesh over this process's ``devices`` (required: a list of
    devices, the same one allowed more than once). With an initialised
    default process group and no ``group`` it spans that group's processes;
    ``FleetMesh(devices)`` builds a mesh of this process alone."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    return FleetMesh(devices, group=group, axis_name=axis_name)


class FleetRuntime:
    """Closed-loop control of N robots with one batched solve per tick on
    ``device`` or over a ``mesh`` (one process's mesh).

    Each robot gets its own ``DWA`` controller for the host-side state
    (path, follower stickiness, adaptive horizon); the device work of all
    robots is one fleet solve. All controllers must share one solver spec
    (the same sample counts, kinematics class and collision shape; only
    the segment capacity may differ, and the largest is taken)."""

    def __init__(
        self,
        robots: Sequence[Robot],
        ctrl_limits,  # RobotCtrlLimits, or one per robot
        config,
        mesh: Optional[FleetMesh] = None,
        host_workers: int = 0,
        *,
        device=None,
    ):
        if isinstance(ctrl_limits, RobotCtrlLimits):
            limits_list = [ctrl_limits] * len(robots)
        else:
            limits_list = list(ctrl_limits)
            if len(limits_list) != len(robots):
                raise ValueError(
                    f"ctrl_limits has {len(limits_list)} entries for "
                    f"{len(robots)} robots"
                )
        check_target(device, mesh, "FleetRuntime")
        if mesh is not None and mesh.multiprocess:
            raise ValueError(
                "FleetRuntime runs its robots' host state in one process: "
                "give it a mesh of this process's devices"
            )
        host_device = device if mesh is None else mesh.devices[0]
        self.controllers: List[DWA] = [
            DWA(robot=r, ctrl_limits=lim, config=config, device=host_device)
            for r, lim in zip(robots, limits_list)
        ]
        # every robot must compile to one shared solver program: the same
        # sample grid, kinematics class and collision shape (the segment
        # capacity is maxed below); mixed fleets belong in DeviceFleet
        protos = [
            {k: v for k, v in c._spec_proto.items() if k != "seg_size"}
            for c in self.controllers
        ]
        if any(pr != protos[0] for pr in protos[1:]):
            raise ValueError(
                "FleetRuntime requires all robots to share one solver spec"
                " (kinematic class, sample counts, collision shape);"
                " per-robot shapes are supported by DeviceFleet instead"
            )
        self.num_robots = len(robots)
        self.device = None if device is None else torch.device(device)
        self.mesh = mesh
        self._solver = None
        self._spec = None
        self._inputs = None
        self._solvers_by_bucket = {}
        self._pool = None
        self.host_workers = int(host_workers)
        self.solver_failures = 0  # cumulative device-dispatch failures
        self.last_tick_seconds = 0.0

    def set_paths(self, paths: Sequence[np.ndarray]):
        if len(paths) != self.num_robots:
            raise ValueError(
                f"{len(paths)} paths for {self.num_robots} robots"
            )
        for ctrl, path in zip(self.controllers, paths):
            ctrl.set_path(path)

    def _ensure_solver(self, scan_bucket: int):
        # keyed per scan bucket, as DWA._solver_for: the first tick's bucket
        # would truncate a longer later scan (and its obstacle points)
        if scan_bucket not in self._solvers_by_bucket:
            spec, _, _ = self.controllers[0]._solver_for(scan_bucket)
            # the fleet computes the dynamic window on the device; the
            # segment capacity covers the fastest robot's lookahead
            seg = max(c._spec_proto["seg_size"] for c in self.controllers)
            spec = dataclasses.replace(spec, device_window=True, seg_size=seg)
            # pad the robot axis to a multiple of the mesh size; pad rows
            # stay zero (no admissible sample: found=False, ignored)
            padded = _round_up(self.num_robots, self.mesh.size if self.mesh else 1)
            self._solvers_by_bucket[scan_bucket] = (
                spec,
                make_fleet_solver(spec, self.device, mesh=self.mesh),
                np.zeros((padded, packed_input_size(spec)), np.float32),
            )
        spec, solver, inputs = self._solvers_by_bucket[scan_bucket]
        if self._spec is not spec:  # rebind only on a bucket change
            self._spec, self._solver, self._inputs = spec, solver, inputs

    def _host_stage(self, i, state, scan):
        """Per-robot host work: follower bookkeeping and the input row.

        Returns a result dict for short-circuited robots (goal reached,
        rotate-in-place), or None when row i was packed for the device
        solve. Touches only controller i and input row i, so different i
        may run on different threads."""
        ctrl = self.controllers[i]
        spec = self._spec
        ctrl.set_current_state(state.x, state.y, state.yaw, state.speed)
        if ctrl.reached_end():
            return dict(found=False, reason="goal_reached")
        target = ctrl.determine_target()
        if (
            ctrl.rotate_in_place
            and abs(target.heading_error)
            > ctrl._config.goal_orientation_tolerance * 10.0
        ):
            r = ctrl._rotate_in_place_result(target.heading_error)
            return dict(
                found=True,
                vx=float(r.trajectory.vx[0]),
                vy=0.0,
                omega=float(r.trajectory.omega[0]),
                cost=0.0,
            )
        ctrl._adapt_prediction_horizon()

        obs = ctrl._obstacle_points_world(scan, None)
        # the single-robot path's non-finite-row filter: one NaN point
        # (a NaN scan angle) would defeat every collision comparison
        obs = obs[np.isfinite(obs).all(axis=1)]
        obs_padded = np.full((spec.scan_size, 2), 1e8, np.float32)
        obs_padded[: len(obs)] = obs[: spec.scan_size]
        start, end = ctrl._tracked_segment_window()
        seg_x, seg_y, seg_arc, seg_total = segment_block(
            ctrl._path.xs, ctrl._path.ys, ctrl._path.arc_lengths,
            start, end, 1e8, spec.seg_size,
        )
        pack_solver_input(
            spec,
            self._inputs[i],
            ctrl._params_vec(),
            (state.x, state.y, state.yaw),
            None,  # device-window mode
            obs_padded,
            min(len(obs), spec.scan_size),
            seg_x,
            seg_y,
            seg_arc,
            end - start + 1,
            seg_total,
            ctrl._path.total_path_length(),
            ctrl._active_points,
            current_vel=(state.vx, state.vy, state.omega),
            limits_vec=ctrl._limits_array,
        )
        return None

    def tick(
        self,
        states: Sequence[RobotState],
        scans: Sequence,
    ) -> List[dict]:
        """One fleet control tick.

        Returns per-robot dicts: {found, vx, vy, omega, cost}. Robots whose
        host stage short-circuits (goal reached, rotate-in-place) need no
        device row (theirs is solved and ignored). ``host_workers`` > 1
        runs the host stage on a thread pool; serial is the default, the
        per-robot stage being too short for thread handoff to pay on a
        few cores."""
        if len(states) != self.num_robots or len(scans) != self.num_robots:
            # zip would truncate to the shortest input: the last robots
            # would get no command and no error
            raise ValueError(
                f"tick needs {self.num_robots} states and scans, got "
                f"{len(states)} states / {len(scans)} scans"
            )
        t0 = time.perf_counter()
        bucket = max(256, _round_up(max(len(s.ranges) for s in scans), 256))
        self._ensure_solver(bucket)
        spec = self._spec

        if self._pool is None and self.host_workers > 1:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=min(self.host_workers, self.num_robots)
            )
        if self._pool is not None:
            results = list(self._pool.map(
                self._host_stage, range(self.num_robots), states, scans))
        else:
            results = [
                self._host_stage(i, s, sc)
                for i, (s, sc) in enumerate(zip(states, scans))
            ]
        needs_solve = [i for i, r in enumerate(results) if r is None]

        if needs_solve:
            out = self._dispatch_with_retry()
            if out is None:
                # both attempts failed: safe-stop commands rather than a
                # crashed control loop
                for i in needs_solve:
                    results[i] = dict(
                        found=False, vx=0.0, vy=0.0, omega=0.0,
                        cost=float("inf"), reason="solver_error",
                    )
            else:
                for i in needs_solve:
                    found, cost, _b, _n, vx, vy, om, _px, _py = (
                        unpack_solver_output(spec, out[i])
                    )
                    results[i] = dict(
                        found=found,
                        vx=float(vx[0]) if found else 0.0,
                        vy=float(vy[0]) if found else 0.0,
                        omega=float(om[0]) if found else 0.0,
                        cost=cost,
                    )
        self.last_tick_seconds = time.perf_counter() - t0
        return results

    def _dispatch_with_retry(self) -> Optional[np.ndarray]:
        """The fleet solve with one re-dispatch on a failure, on the same
        device and kernels: a second failure degrades this tick to
        safe-stop commands and adds to ``solver_failures`` (each failed
        attempt counts) for the operator to alarm on."""
        for attempt in (0, 1):
            try:
                out = self._solver(self._inputs)
                if self.mesh is not None:
                    return self.mesh.host_rows(out)
                return out.cpu().numpy()
            except Exception:  # noqa: BLE001 - any device error
                self.solver_failures += 1
                if attempt == 1:
                    logging.getLogger(__name__).exception(
                        "fleet solve failed twice; emitting safe-stop"
                    )
        return None
