from .fleet import FleetPlanner, make_fleet_solver  # noqa: F401
from .fleet_v2 import DeviceFleet  # noqa: F401
