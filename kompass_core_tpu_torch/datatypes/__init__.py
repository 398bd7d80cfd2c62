"""Sensor and path datatypes: the port's own copies of the JAX package's
host code (NumPy and attrs, no JAX), with the same code and numerics."""

from .laserscan import LaserScanData  # noqa: F401
from .path import InterpolationType, ReferencePath  # noqa: F401
from .pointcloud import PointCloudData  # noqa: F401
from .pose import PoseData  # noqa: F401
from .scan_model import ScanModelConfig  # noqa: F401
