"""Controller result types (reference ``controller.h:18-28`` Result and the
FollowingStatus enum exposed to Python)."""

from enum import Enum

from attrs import define, field


class FollowingStatus(Enum):
    GOAL_REACHED = "GOAL_REACHED"
    COMMAND_FOUND = "COMMAND_FOUND"
    NO_COMMAND_POSSIBLE = "NO_COMMAND_POSSIBLE"
    LOOSING_GOAL = "LOOSING_GOAL"


@define
class VelocityCommand:
    vx: float = field(default=0.0)
    vy: float = field(default=0.0)
    omega: float = field(default=0.0)
    steer_ang: float = field(default=0.0)


@define
class FollowingResult:
    status: FollowingStatus = field(default=FollowingStatus.NO_COMMAND_POSSIBLE)
    velocity_command: VelocityCommand = field(factory=VelocityCommand)
