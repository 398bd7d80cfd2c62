"""The fleet of mixed drives: a ``kompass_core_tpu_torch`` ``DeviceFleet``
of robots of several kinds (``"system": "fleet_kin"``; robot i of
``robot.kinds[i % len(kinds)]``, each kind its drive, cylinder and
limits), driven and recorded as the ``fleet`` system drives its fleet,
and judged by the plain reference ``reference/fleet_kin.py``.

Any omni robot makes the whole fleet's grid omni-shaped, in the program
and in the reference: ``work`` counts the sweep at that grid for every
robot, as both compute it. The check judges at least one robot of each
drive.
"""

import numpy as np
import torch

from ..reference.fleet_kin import KinLayout, kinds_of
from ..roofline import sweep_shape
from . import fleet, fleet_kin_judge

DWA_KEYS = ("max_linear_samples", "max_angular_samples", "prediction_horizon",
            "control_horizon", "control_time_step", "max_point_interpolation_distance",
            "path_segment_length", "goal_dist_tolerance", "goal_orientation_tolerance",
            "loosing_goal_distance", "curvature_horizon_tolerance", "octree_resolution",
            "drop_samples")


def build_fleet(cfg: dict, n: int, device):
    """The configuration's fleet of ``n`` robots on ``device``."""
    from kompass_core_tpu_torch.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits, RobotGeometry,
        RobotType,
    )
    from kompass_core_tpu_torch.parallel.fleet_v2 import DeviceFleet

    kinds = kinds_of(cfg, n)
    robots = [Robot(robot_type=RobotType[k["drive"]],
                    geometry_type=RobotGeometry.Type[k["geometry"]],
                    geometry_params=np.array(k["params"])) for k in kinds]

    def limits(lim):
        extra = {}
        if "vy" in lim:
            extra["vy_limits"] = LinearCtrlLimits(*lim["vy"])
        return RobotCtrlLimits(vx_limits=LinearCtrlLimits(*lim["vx"]),
                               omega_limits=AngularCtrlLimits(*lim["omega"]), **extra)

    d = cfg["dwa"]
    config = DWAConfig(**{key: d[key] for key in DWA_KEYS},
                       costs_weights=TrajectoryCostsWeights(**d["weights"]))
    return DeviceFleet(
        robots, [limits(k["limits"]) for k in kinds], config, scan_rays=cfg["scan_rays"],
        path_capacity=cfg["path_capacity"], max_segments=cfg["max_segments"],
        sensor_max_range=cfg["sensor_max_range"],
        tracked_obstacles=cfg["tracked_obstacles"], device=device)


class System(fleet.System):
    """One cell's fleet of mixed drives on ``device``
    (``systems/__init__.py``)."""

    def __init__(self, cfg, traffic, scene, seed, device):
        self.cfg, self.scene, self.seed = cfg, scene, seed
        self.device = torch.device(device)
        self.n, self.k = scene.n, scene.k
        layout = KinLayout(cfg, scene.n)
        self.fleet = build_fleet(cfg, scene.n, self.device)
        self.fleet.set_paths(scene.paths)
        self.fleet.set_scan_angles(scene.angles)
        self._call = fleet.entry(self.fleet, scene.k)
        drives = [np.flatnonzero(layout.drive == d) for d in np.unique(layout.drive)]
        self.rec = fleet.Record(scene.n, scene.k, fleet.sample_rows(
            scene.n, int(traffic["check_robots"]), seed, strata=drives))
        self.check_calls = int(traffic["check_calls"])
        self.work = sweep_shape(layout)

    def check(self, first_call, control=False):
        return fleet_kin_judge.check(self.cfg, self.rec, self.scene.paths,
                                     self.scene.angles, self.device, first_call,
                                     self.check_calls, self.seed, control=control)
