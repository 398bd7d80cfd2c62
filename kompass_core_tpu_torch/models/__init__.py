"""Robot models: the port's own copies of the JAX package's host code
(NumPy and attrs, no JAX), with the same code and numerics."""

from .footprint import (  # noqa: F401
    CircularFootprint,
    RectangleFootprint,
    footprint_types,
)
from .robot import (  # noqa: F401
    AckermannControl,
    AngularCtrlLimits,
    DifferentialDriveControl,
    LinearCtrlLimits,
    MotionControl,
    MotionModel2D,
    MotionModel2DParams,
    OmniControl,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotState,
    RobotType,
)

# reference-compatible name (models.py:1109 OmniDirectionalControl)
OmniDirectionalControl = OmniControl
