"""Sensor and path datatypes, shared with ``kompass_core_tpu`` by import
(JAX-free host code)."""

from kompass_core_tpu.datatypes.laserscan import LaserScanData  # noqa: F401
from kompass_core_tpu.datatypes.path import (  # noqa: F401
    InterpolationType,
    ReferencePath,
)
from kompass_core_tpu.datatypes.pointcloud import PointCloudData  # noqa: F401
from kompass_core_tpu.datatypes.pose import PoseData  # noqa: F401
from kompass_core_tpu.datatypes.scan_model import ScanModelConfig  # noqa: F401
