"""The fleet system: a ``kompass_core_tpu_torch`` ``DeviceFleet`` built
from a configuration file (``"system": "fleet"``), driven through one of
its two entry points, ``tick`` (k = 1) or ``run_ticks_on_device`` (a
k-tick call), and judged by the plain reference ``reference/fleet.py``.

Its scenes give ``n`` robots, ``k`` ticks per call, the scan ``angles``,
the raw ``paths``, per call ``inputs()`` = (states [n, 4], velocities
[n, 3], ranges [n, rays], tracked movers [n, M, 4] or None), and may name
``check_always``: robots the output check always judges.
"""

import numpy as np
import torch

from ..reference.fleet import Layout
from ..roofline import sweep_shape
from . import fleet_judge

OUT_FIELDS = ("found", "reached", "vx", "vy", "omega", "cost", "active_points",
              "num_admissible", "safety_factor")


def build_fleet(cfg: dict, n: int, device):
    """The configuration's fleet of ``n`` robots on ``device``."""
    from kompass_core_tpu_torch.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits, RobotGeometry,
        RobotType,
    )
    from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet, FleetSafetyConfig

    rb = cfg["robot"]
    box_every = int(rb.get("box_every", 0))
    robots = [
        Robot(robot_type=RobotType[rb["drive"]],
              geometry_type=RobotGeometry.Type.BOX,
              geometry_params=np.array(rb["box_params"]))
        if box_every and i % box_every == 0 else
        Robot(robot_type=RobotType[rb["drive"]],
              geometry_type=RobotGeometry.Type.CYLINDER,
              geometry_params=np.array(rb["circle_params"]))
        for i in range(n)]
    lim = cfg["limits"]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=lim["vx"][0], max_acc=lim["vx"][1],
                                   max_decel=lim["vx"][2]),
        omega_limits=AngularCtrlLimits(max_vel=lim["omega"][0], max_acc=lim["omega"][1],
                                       max_decel=lim["omega"][2]),
    )
    d = cfg["dwa"]
    config = DWAConfig(
        max_linear_samples=d["max_linear_samples"],
        max_angular_samples=d["max_angular_samples"],
        prediction_horizon=d["prediction_horizon"],
        control_horizon=d["control_horizon"],
        control_time_step=d["control_time_step"],
        max_point_interpolation_distance=d["max_point_interpolation_distance"],
        path_segment_length=d["path_segment_length"],
        goal_dist_tolerance=d["goal_dist_tolerance"],
        goal_orientation_tolerance=d["goal_orientation_tolerance"],
        loosing_goal_distance=d["loosing_goal_distance"],
        curvature_horizon_tolerance=d["curvature_horizon_tolerance"],
        octree_resolution=d["octree_resolution"],
        drop_samples=d["drop_samples"],
        costs_weights=TrajectoryCostsWeights(**d["weights"]),
    )
    peers = cfg.get("peers")
    safety = cfg.get("safety")
    return DeviceFleet(
        robots, limits, config, scan_rays=cfg["scan_rays"],
        path_capacity=cfg["path_capacity"], max_segments=cfg["max_segments"],
        sensor_max_range=cfg["sensor_max_range"],
        peer_avoidance=bool(peers), peer_ring_points=peers["ring"] if peers else 8,
        peer_prediction=bool(peers and peers["predict"]),
        safety_config=None if not safety else FleetSafetyConfig(
            critical_angle_deg=safety["critical_angle_deg"],
            critical_distance=safety["critical_distance"],
            slowdown_distance=safety["slowdown_distance"]),
        tracked_obstacles=cfg["tracked_obstacles"], device=device,
    )


def entry(fleet, k: int):
    """The cell's entry point: fn(states, vels, ranges, angles, tracked)
    -> the output dict of numpy arrays. One ``DeviceFleet.tick`` for
    k = 1, one ``run_ticks_on_device(k, ...)`` call otherwise."""
    if k == 1:
        return lambda s, v, r, a, trk: fleet.tick(s, v, r, a, tracked=trk)
    return lambda s, v, r, a, trk: fleet.run_ticks_on_device(k, s, v, r, a, tracked=trk)


def sample_rows(n: int, count: int, seed: int, strata=(), always=()):
    """The robots the check judges, drawn from the seed: every robot of
    ``always``, one of each stratum (an array of robots) that holds none
    of them yet, and the rest uniform, ``count`` in all (or more, where
    ``always`` and the strata ask for more)."""
    rng = np.random.default_rng([int(seed), 1])
    chosen = list(dict.fromkeys(int(i) for i in always))
    for group in strata:
        group = np.asarray(group, np.int64)
        if len(group) and not np.isin(group, chosen).any():
            chosen.append(int(rng.choice(group)))
    rest = np.setdiff1d(np.arange(n), chosen)
    extra = min(max(0, count - len(chosen)), len(rest))
    chosen += [int(i) for i in rng.choice(rest, extra, replace=False)]
    return np.sort(np.array(chosen, np.int64))


class Record:
    """What the output check needs, on the host: every call's states and
    velocities of the whole fleet, the sampled robots' scans, tracked
    movers and outputs, and (k-tick calls) every robot's per-tick
    commands."""

    def __init__(self, n: int, k: int, rows):
        self.n, self.k = n, k
        self.rows = np.asarray(rows, np.int64)
        self.calls = []  # per call: a dict of host arrays

    def add(self, states, vels, ranges, tracked, out):
        r = self.rows
        c = dict(
            states=np.array(states, np.float32, copy=True),
            vels=np.array(vels, np.float32, copy=True),
            ranges=np.array(ranges[r], np.float32, copy=True),
            tracked=None if tracked is None else np.array(tracked[r], np.float32),
            out={f: np.array(out[f][r]) for f in OUT_FIELDS},
        )
        if self.k > 1:
            c["cmds"] = np.stack([out[f] for f in ("vx", "vy", "omega")], -1).astype(
                np.float32)
            c["final"] = np.array(out["final_states"][r], np.float32)
        self.calls.append(c)


class System:
    """One cell's fleet on ``device`` (``systems/__init__.py``)."""

    def __init__(self, cfg, traffic, scene, seed, device):
        self.cfg, self.scene, self.seed = cfg, scene, seed
        self.device = torch.device(device)
        self.n, self.k = scene.n, scene.k
        layout = Layout(cfg, scene.n)
        self.fleet = build_fleet(cfg, scene.n, self.device)
        self.fleet.set_paths(scene.paths)
        self.fleet.set_scan_angles(scene.angles)
        self._call = entry(self.fleet, scene.k)
        classes = (np.flatnonzero(layout.is_box), np.flatnonzero(~layout.is_box))
        self.rec = Record(scene.n, scene.k, sample_rows(
            scene.n, int(traffic["check_robots"]), seed, strata=classes,
            always=getattr(scene, "check_always", ())))
        self.check_calls = int(traffic["check_calls"])
        self.work = sweep_shape(layout)

    def call(self, inputs):
        states, vels, ranges, tracked = inputs
        return self._call(states, vels, ranges, self.scene.angles, tracked)

    def record(self, inputs, out):
        self.rec.add(*inputs, out)

    def solves(self, out):
        return self.n * self.k

    def counts(self, out):
        return {"ticks": self.k, "robot_ticks": self.n * self.k,
                "active_steps": int(np.asarray(out["active_points"]).sum())}

    def release(self):
        del self.fleet, self._call

    def check(self, first_call, control=False):
        return fleet_judge.check(self.cfg, self.rec, self.scene.paths, self.scene.angles,
                                 self.device, first_call, self.check_calls, self.seed,
                                 control=control)
