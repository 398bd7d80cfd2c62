"""Obstacle containers and occupancy/obstacle type enums.

API-equivalent of the reference's ``datatypes/obstacles.py``: grid
metadata + per-obstacle SoA columns spanning occupancy info (global and
local coordinates, grid indices, occupied zone), semantics (YOLO class
id) and tracking (object id, velocity), plus ``split_obstacles_by_type``.

Columns are plain Python lists like the reference (these are host-side
bookkeeping containers that grow incrementally; the device kernels
consume dense arrays produced elsewhere).
"""

from enum import IntEnum
from typing import Tuple

from .pose import PoseData

_COLUMNS = (
    "obstacle_type",
    "x_global",
    "y_global",
    "x_local",
    "y_local",
    "i_grid",
    "j_grid",
    "occupied_zone",
    "class_id",
    "object_id",
    "vx",
    "vy",
)


class OCCUPANCY_TYPE(IntEnum):
    """Occupancy status of a grid cell (reference
    ``datatypes/obstacles.py:7-14``)."""

    UNEXPLORED = -1
    EMPTY = 0
    OCCUPIED = 100


class OBSTACLE_TYPE(IntEnum):
    """Obstacle provenance (reference ``datatypes/obstacles.py:17-27``):
    SCAN from a laser scan, SEMANTIC from an RGB segmentation model."""

    SCAN = 1
    SEMANTIC = 2


class ObstaclesData:
    """Obstacles detected and mapped on a grid around the robot
    (reference ``datatypes/obstacles.py:30-238``).

    Metadata: ``resolution`` (m/cell), ``width``/``height`` (cells),
    ``origin_pose`` (grid (0,0) in the global frame), ``robot_pose``.
    Per-obstacle columns: see module docstring.
    """

    def __init__(self):
        self.resolution = 1.0
        self.width = 0
        self.height = 0
        self.origin_pose = PoseData()
        self.robot_pose = PoseData()
        for col in _COLUMNS:
            setattr(self, col, [])

    # --- size / consistency ---

    def get_length(self) -> int:
        self.check_attributes_equal_length()
        return len(self.obstacle_type)

    def __len__(self) -> int:
        return len(self.obstacle_type)

    def check_attributes_equal_length(self):
        n = len(self.obstacle_type)
        bad = [c for c in _COLUMNS if len(getattr(self, c)) != n]
        assert not bad, f"column length mismatch: {bad}"

    # --- mutation ---

    def add_obstacle(
        self,
        obstacle_type: int,
        x_global: float,
        y_global: float,
        x_local: float = 0.0,
        y_local: float = 0.0,
        i_grid: int = 0,
        j_grid: int = 0,
        occupied_zone: float = 0.0,
        class_id: int = -1,
        object_id: int = -1,
        vx: float = 0.0,
        vy: float = 0.0,
    ):
        vals = locals()
        for col in _COLUMNS:
            getattr(self, col).append(vals[col])

    def merge_obstacles(self, obstacles: "ObstaclesData"):
        for col in _COLUMNS:
            getattr(self, col).extend(getattr(obstacles, col))

    def update_metadata(
        self,
        resolution: float,
        width: int,
        height: int,
        origin_pose: PoseData,
        robot_pose: PoseData,
    ):
        self.resolution = resolution
        self.width = width
        self.height = height
        self.origin_pose = origin_pose
        self.robot_pose = robot_pose

    def remove_obstacle_by_index(self, obstacle_index: int):
        for col in _COLUMNS:
            del getattr(self, col)[obstacle_index]

    def remove_obstacle_by_object_id(self, object_id: int):
        idx = self.object_id.index(object_id)
        self.remove_obstacle_by_index(idx)


def split_obstacles_by_type(
    obstacles: ObstaclesData,
) -> Tuple[ObstaclesData, ObstaclesData]:
    """Split into (scan, semantic) instances sharing the source metadata
    (reference ``datatypes/obstacles.py:244-``)."""
    out = {
        OBSTACLE_TYPE.SCAN: ObstaclesData(),
        OBSTACLE_TYPE.SEMANTIC: ObstaclesData(),
    }
    for dst in out.values():
        dst.update_metadata(
            obstacles.resolution,
            obstacles.width,
            obstacles.height,
            obstacles.origin_pose,
            obstacles.robot_pose,
        )
    for k in range(len(obstacles)):
        try:
            kind = OBSTACLE_TYPE(obstacles.obstacle_type[k])
        except ValueError:
            continue  # unknown type codes are skipped, not fatal
        dst = out.get(kind)
        if dst is None:
            continue
        for col in _COLUMNS:
            getattr(dst, col).append(getattr(obstacles, col)[k])
    return out[OBSTACLE_TYPE.SCAN], out[OBSTACLE_TYPE.SEMANTIC]
