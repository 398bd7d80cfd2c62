"""Robot models, shared with ``kompass_core_tpu`` by import (JAX-free
host code): the port's ``DWA`` takes the same ``Robot`` and
``RobotCtrlLimits`` objects as the JAX one."""

from kompass_core_tpu.models import (  # noqa: F401
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotState,
    RobotType,
)
