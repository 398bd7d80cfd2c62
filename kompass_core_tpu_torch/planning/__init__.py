"""Global planning on a PyTorch device: the counterpart of
``kompass_core_tpu/planning`` (see ``planner.py``)."""

from .fleet_planner import solve_fleet_prm  # noqa: F401
from .planner import (  # noqa: F401
    GlobalPlanner,
    GlobalPlannerConfig,
    OMPLGeometric,
    OMPLGeometricConfig,
    planner_registry,
)
