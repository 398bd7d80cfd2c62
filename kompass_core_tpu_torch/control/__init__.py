"""The port's controllers and their registry: DWA on the device, and the
host controllers (Stanley, DVZ, Pure Pursuit and the two vision
followers), copies of the JAX package's JAX-free modules with the same
code and numerics. The host controllers launch nothing on a device and
take no ``device``; DWA (and Pure Pursuit's use of its host helpers)
keeps its own."""

from enum import Enum
from typing import List, Optional, Type, TypeVar

from .follower import Follower, FollowerConfig, FollowingTarget  # noqa: F401
from .result import FollowingResult, FollowingStatus, VelocityCommand  # noqa: F401
from .trajectory_costs import TrajectoryCostsWeights  # noqa: F401
from .dwa import DWA, DWAConfig  # noqa: F401
from .pid import PID  # noqa: F401
from .stanley import Stanley, StanleyConfig  # noqa: F401
from .pure_pursuit import PurePursuit, PurePursuitConfig  # noqa: F401
from .dvz import DVZ, DVZConfig  # noqa: F401
from .vision_followers import (  # noqa: F401
    VisionRGBDFollower,
    VisionRGBDFollowerConfig,
    VisionRGBFollower,
    VisionRGBFollowerConfig,
)

# reference surface aliases (``control/__init__.py:18``, ``_base_.py:209``):
# the reference's FollowerTemplate is the shared loop_step/path-following
# base of every wrapper controller; here that role is played by Follower
FollowerTemplate = Follower
ControllerType = FollowerTemplate

T = TypeVar("T", bound="StrEnum")


class StrEnum(str, Enum):
    """Enum with string values and lookup helpers (reference
    ``control/__init__.py:23-66``). The ``str`` mixin makes members
    hash/compare equal to their value, so registry dicts accept either
    the enum member or its plain string."""

    @classmethod
    def get_enum(cls: Type[T], __value: str) -> Optional[T]:
        for enum_member in cls:
            if enum_member.value == __value:
                return enum_member
        return None

    @classmethod
    def values(cls) -> List:
        return [member.value for member in cls]

    def __str__(self) -> str:
        return self.value

    def __repr__(self) -> str:
        return self.value


class ControllersID(StrEnum):
    """Registry ids of the local planners (reference
    ``control/__init__.py:67-78``)."""

    STANLEY = "Stanley"
    DWA = "DWA"
    DVZ = "DVZ"
    VISION_IMG = "VisionRGBFollower"
    VISION_DEPTH = "VisionRGBDFollower"
    PURE_PURSUIT = "PurePursuit"


ControlClasses = {
    ControllersID.STANLEY: Stanley,
    ControllersID.DVZ: DVZ,
    ControllersID.DWA: DWA,
    ControllersID.VISION_IMG: VisionRGBFollower,
    ControllersID.VISION_DEPTH: VisionRGBDFollower,
    ControllersID.PURE_PURSUIT: PurePursuit,
}

ControlConfigClasses = {
    ControllersID.STANLEY: StanleyConfig,
    ControllersID.DVZ: DVZConfig,
    ControllersID.DWA: DWAConfig,
    ControllersID.VISION_IMG: VisionRGBFollowerConfig,
    ControllersID.VISION_DEPTH: VisionRGBDFollowerConfig,
    ControllersID.PURE_PURSUIT: PurePursuitConfig,
}
