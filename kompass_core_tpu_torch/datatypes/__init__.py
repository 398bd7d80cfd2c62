"""Sensor and path datatypes: the port's own copies of the JAX package's
host code (NumPy and attrs, no JAX), with the same code and numerics."""

from .laserscan import LaserScanData  # noqa: F401
from .obstacles import (  # noqa: F401
    OBSTACLE_TYPE,
    OCCUPANCY_TYPE,
    ObstaclesData,
    split_obstacles_by_type,
)
from .path import InterpolationType, ReferencePath  # noqa: F401
from .path_sample import (  # noqa: F401
    InterpolationPoint,
    MotionSample,
    Odom2D,
    PathPoint,
    PathSample,
    PathTrackingError,
    Point2D,
    Range2D,
    TrackedPoint,
    TrajectorySample,
)
from .pcd import (  # noqa: F401
    get_occupancy_grid_from_pcd,
    get_points_from_pcd,
    read_pcd,
    read_pcd_to_occupancy_grid,
)
from .pointcloud import (  # noqa: F401
    PointCloudData,
    pointcloud_to_laserscan_from_raw,
)
from .pose import PoseData  # noqa: F401
from .scan_model import ScanModelConfig  # noqa: F401
from .tracking import (  # noqa: F401
    Bbox2D,
    Bbox3D,
    PointsOfInterest,
    TrackedBbox3D,
    TrackedPose2D,
)
