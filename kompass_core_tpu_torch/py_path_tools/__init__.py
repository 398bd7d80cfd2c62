from .executor import (  # noqa: F401
    PathExecutor,
    PathExecutorParams,
    PathRecorder,
    WaypointExecutor,
    follower_types,
)
from .interpolation import (  # noqa: F401
    Spline,
    SplineInterpolatedPath,
    interpolate_path,
    resample_path,
)
