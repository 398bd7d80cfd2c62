from .fleet import (  # noqa: F401
    FleetPlanner,
    make_fleet_solver,
    make_sample_parallel_solver,
)
from .fleet_v2 import DeviceFleet, FleetSafetyConfig  # noqa: F401
from .multihost import (  # noqa: F401
    FleetMesh,
    FleetRuntime,
    build_fleet_mesh,
    initialize_multihost,
)
