from .follower import Follower, FollowerConfig, FollowingTarget  # noqa: F401
from .result import FollowingResult, FollowingStatus, VelocityCommand  # noqa: F401
from .trajectory_costs import TrajectoryCostsWeights  # noqa: F401
from .dwa import DWA, DWAConfig  # noqa: F401
