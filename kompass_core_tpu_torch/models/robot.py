"""Robot models: geometry, kinematic types, control limits, and 2D state.

The port's copy of ``kompass_core_tpu/models/robot.py``, API-equivalent
to the reference front-end's ``kompass_core/models.py``: ``RobotType``,
``RobotGeometry`` (+``Type``), ``RobotState`` with a calibratable 2D motion
model, control-limit containers, and the ``Robot`` aggregate used by all
controllers. Implementation is original (plain attrs + numpy).
"""

import math
from enum import Enum
from typing import List, Optional

import numpy as np
from attrs import Factory, define, field

from ..utils.angles import normalize_to_minus_pi_pi
from ..utils.config import BaseAttrs, base_validators


class RobotType(Enum):
    """Kinematic class of the robot base."""

    ACKERMANN = "ACKERMANN"
    DIFFERENTIAL_DRIVE = "DIFFERENTIAL_DRIVE"
    OMNI = "OMNI"

    @classmethod
    def values(cls) -> List[str]:
        return [m.value for m in cls]

    @classmethod
    def from_str(cls, value):
        if isinstance(value, cls):
            return value
        for m in cls:
            if value == m.value or value == str(m):
                return m
        raise ValueError(f"{value} is not a valid RobotType")

    @classmethod
    def to_str(cls, enum_value) -> str:
        """String value of a member (or validate an already-string value);
        reference ``models.py:687-706``."""
        if isinstance(enum_value, cls):
            return enum_value.value
        if enum_value in cls.values():
            return enum_value
        raise ValueError(f"{enum_value} is not a valid RobotType")


class RobotGeometry:
    """Robot geometry types, parameter validation and derived quantities.

    Parameter conventions (same as reference ``models.py:656-`):
    CYLINDER=(radius, height), BOX=(x, y, z), SPHERE=(radius,),
    ELLIPSOID=(x, y, z), CAPSULE=(radius, height), CONE=(radius, height).
    """

    class Type(Enum):
        BOX = "BOX"
        CYLINDER = "CYLINDER"
        SPHERE = "SPHERE"
        ELLIPSOID = "ELLIPSOID"
        CAPSULE = "CAPSULE"
        CONE = "CONE"

        @classmethod
        def values(cls) -> List[str]:
            return [m.value for m in cls]

        @classmethod
        def from_str(cls, value):
            if isinstance(value, cls):
                return value
            for m in cls:
                if value == m.value or value == str(m):
                    return m
            raise ValueError(f"{value} is not a valid RobotGeometry.Type")

    PARAMS_LENGTH = {
        "BOX": 3,
        "CYLINDER": 2,
        "SPHERE": 1,
        "ELLIPSOID": 3,
        "CAPSULE": 2,
        "CONE": 2,
    }

    _ROUND = ("CYLINDER", "SPHERE", "CAPSULE", "CONE")

    @classmethod
    def is_valid_parameters(cls, geometry_type, parameters) -> bool:
        required = cls.PARAMS_LENGTH[geometry_type.value]
        return len(parameters) == required and all(p > 0 for p in parameters)

    @classmethod
    def get_wheelbase(cls, geometry_type, parameters) -> float:
        if not cls.is_valid_parameters(geometry_type, parameters):
            raise ValueError("Invalid parameters for the robot geometry")
        if geometry_type.value in cls._ROUND:
            return float(parameters[0])
        return float(parameters[1])

    @classmethod
    def get_radius(cls, geometry_type, parameters) -> float:
        """Circumscribed planar radius used by the point-robot collision
        model (reference collision model: ``collision_check.cpp:38-55``
        — cylinder/sphere radius, box half-diagonal)."""
        if not cls.is_valid_parameters(geometry_type, parameters):
            raise ValueError("Invalid parameters for the robot geometry")
        if geometry_type.value in cls._ROUND:
            return float(parameters[0])
        # box-like: half diagonal of the (x, y) footprint
        return float(
            math.sqrt(parameters[0] ** 2 + parameters[1] ** 2) / 2.0
        )

    @classmethod
    def get_height(cls, geometry_type, parameters) -> float:
        if not cls.is_valid_parameters(geometry_type, parameters):
            raise ValueError("Invalid parameters for the robot geometry")
        t = geometry_type.value
        if t in ("CYLINDER", "CAPSULE", "CONE", "ELLIPSOID"):
            return float(parameters[-1])
        if t == "SPHERE":
            return float(parameters[0] * 2.0)
        return float(parameters[2])

    @classmethod
    def get_length(cls, geometry_type, parameters) -> Optional[float]:
        """Robot base length, or None on invalid parameters (reference
        ``models.py:839-853``)."""
        if not cls.is_valid_parameters(geometry_type, parameters):
            return None
        return float(parameters[0])

    @classmethod
    def get_footprint(cls, geometry_type, parameters):
        """2D footprint from the geometry (reference ``models.py:856-880``):
        round shapes -> CircularFootprint(radius), box-like ->
        RectangleFootprint(width=y, length=x)."""
        from .footprint import CircularFootprint, RectangleFootprint

        if geometry_type.value in cls._ROUND:
            return CircularFootprint(rad=float(parameters[0]))
        return RectangleFootprint(
            width=float(parameters[1]), length=float(parameters[0])
        )


@define
class MotionModel2DParams(BaseAttrs):
    """Calibration parameters of the 2D motion model (reference
    ``models.py:15-42``, same field names and [0, 1.5] ranges)."""

    x_dot_prop_vx: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1.5)
    )
    x_dot_prop_vy: float = field(
        default=0.0, validator=base_validators.in_range(0.0, 1.5)
    )
    y_dot_prop_vx: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1.5)
    )
    y_dot_prop_vy: float = field(
        default=0.0, validator=base_validators.in_range(0.0, 1.5)
    )
    yaw_dot_prop: float = field(
        default=1.0, validator=base_validators.in_range(0.0, 1.5)
    )


@define(init=False)
class MotionModel2D(BaseAttrs):
    """Calibratable proportional 2D motion model.

    x_dot = a_xx * vx * cos(yaw) - a_xy * vy * sin(yaw)
    y_dot = a_yx * vx * sin(yaw) + a_yy * vy * cos(yaw)
    yaw_dot = a_w * omega

    Defaults match ``MotionModel2DParams`` (and the reference,
    ``models.py:48-57``, which default-constructs the params): the vx/yaw
    gains are 1.0 and the vy gains are 0.0 ("default 0 for non-holonomic
    motion", ``models.py:24-37``) — so ``MotionModel2D()`` and
    ``MotionModel2D(MotionModel2DParams())`` are the same ideal unicycle
    model. Constructible from a :class:`MotionModel2DParams` or from
    keyword fields directly.
    """

    x_dot_prop_vx: float = field(default=1.0)
    x_dot_prop_vy: float = field(default=0.0)
    y_dot_prop_vx: float = field(default=1.0)
    y_dot_prop_vy: float = field(default=0.0)
    yaw_dot_prop_omega: float = field(default=1.0)

    def __init__(self, params: Optional[MotionModel2DParams] = None, **kwargs):
        if params is not None:
            kwargs.setdefault("x_dot_prop_vx", params.x_dot_prop_vx)
            kwargs.setdefault("x_dot_prop_vy", params.x_dot_prop_vy)
            kwargs.setdefault("y_dot_prop_vx", params.y_dot_prop_vx)
            kwargs.setdefault("y_dot_prop_vy", params.y_dot_prop_vy)
            kwargs.setdefault("yaw_dot_prop_omega", params.yaw_dot_prop)
        self.__attrs_init__(**kwargs)

    @property
    def yaw_dot_prop(self) -> float:
        """Reference field name for the angular gain (``models.py:39``)."""
        return self.yaw_dot_prop_omega

    @yaw_dot_prop.setter
    def yaw_dot_prop(self, value: float) -> None:
        self.yaw_dot_prop_omega = float(value)

    @property
    def params(self) -> MotionModel2DParams:
        """Snapshot of the current gains as the reference params class."""
        return MotionModel2DParams(
            x_dot_prop_vx=self.x_dot_prop_vx,
            x_dot_prop_vy=self.x_dot_prop_vy,
            y_dot_prop_vx=self.y_dot_prop_vx,
            y_dot_prop_vy=self.y_dot_prop_vy,
            yaw_dot_prop=self.yaw_dot_prop_omega,
        )

    @classmethod
    def x_model(cls, X: tuple, x_dot_prop_vx: float, x_dot_prop_vy: float) -> float:
        """x-axis model on inputs (x_old, yaw_old, v_x, v_y, dt)
        (reference ``models.py:60-84``)."""
        x_old, yaw_old, v_x, v_y, dt = X
        return x_old + (
            x_dot_prop_vx * v_x * np.cos(yaw_old)
            - x_dot_prop_vy * v_y * np.sin(yaw_old)
        ) * dt

    @classmethod
    def y_model(cls, X: tuple, y_dot_prop_vx: float, y_dot_prop_vy: float) -> float:
        """y-axis model on inputs (y_old, yaw_old, v_x, v_y, dt)
        (reference ``models.py:86-110``)."""
        y_old, yaw_old, v_x, v_y, dt = X
        return y_old + (
            y_dot_prop_vx * v_x * np.sin(yaw_old)
            + y_dot_prop_vy * v_y * np.cos(yaw_old)
        ) * dt

    @classmethod
    def heading_model(cls, X: tuple, yaw_dot_prop: float) -> float:
        """Heading model on inputs (yaw_old, omega, dt); wraps into
        [0, 2pi) like the reference (``models.py:112-129``)."""
        yaw_old, omega, dt = X
        return float(
            np.mod(yaw_old + (yaw_dot_prop * omega) * dt, 2.0 * np.pi)
        )

    def apply(self, state_xyyaw: np.ndarray, v_x, v_y, omega, dt) -> np.ndarray:
        x, y, yaw = state_xyyaw
        return np.array(
            [
                self.x_model(
                    (x, yaw, v_x, v_y, dt),
                    self.x_dot_prop_vx,
                    self.x_dot_prop_vy,
                ),
                self.y_model(
                    (y, yaw, v_x, v_y, dt),
                    self.y_dot_prop_vx,
                    self.y_dot_prop_vy,
                ),
                self.heading_model((yaw, omega, dt), self.yaw_dot_prop_omega),
            ]
        )

    def set_params_from_file(self, path_to_file: str) -> None:
        """Load the gains from a config file's 'robot' section
        (reference ``models.py:174-181``)."""
        params = self.params
        params.from_file(path_to_file, nested_root_name="robot")
        self.set_linear_x_params([params.x_dot_prop_vx, params.x_dot_prop_vy])
        self.set_linear_y_params([params.y_dot_prop_vx, params.y_dot_prop_vy])
        self.set_angular_params([params.yaw_dot_prop])

    def set_linear_x_params(self, params: List[float]) -> None:
        """[x_dot_prop_vx, x_dot_prop_vy] (reference ``models.py:183-191``)."""
        self.x_dot_prop_vx, self.x_dot_prop_vy = params[0], params[1]

    def set_linear_y_params(self, params: List[float]) -> None:
        """[y_dot_prop_vx, y_dot_prop_vy] (reference ``models.py:193-201``)."""
        self.y_dot_prop_vx, self.y_dot_prop_vy = params[0], params[1]

    def set_angular_params(self, params: List[float]) -> None:
        """[yaw_dot_prop] (reference ``models.py:203-211``)."""
        self.yaw_dot_prop_omega = params[0]

    def __str__(self) -> str:
        return f"""Kinematic Model:
        dx/dt = {self.x_dot_prop_vx:.3f} * V_x * cos(yaw) - {self.x_dot_prop_vy:.3f} * V_y * sin(yaw)
        dy/dt = {self.y_dot_prop_vx:.3f} * V_x * sin(yaw) + {self.y_dot_prop_vy:.3f} * V_y * cos(yaw)
        dyaw/dt = {self.yaw_dot_prop_omega:.3f} * Omega"""


@define
class RobotState:
    """2D robot state (pose + velocity)."""

    model: MotionModel2D = field(default=Factory(MotionModel2D))
    x: float = field(default=0.0)
    y: float = field(default=0.0)
    yaw: float = field(default=0.0)
    speed: float = field(default=0.0)
    vx: float = field(default=0.0)
    vy: float = field(default=0.0)
    omega: float = field(default=0.0)

    def simulate(self, v_x: float, omega: float, dt: float, v_y: float = 0.0):
        """Advance the pose one step with the motion model and update the
        signed speed (sign convention mirrors reference
        ``models.py:238-268``)."""
        new = self.model.apply(
            np.array([self.x, self.y, self.yaw]), v_x=v_x, v_y=v_y, omega=omega, dt=dt
        )
        dir_robot = np.sign(normalize_to_minus_pi_pi(new[2]))
        dir_x = np.sign(new[0] - self.x) * dir_robot
        dir_y = np.sign(new[1] - self.y) * dir_robot
        dir_speed = -1.0 if (dir_x < 0 and dir_y < 0) else 1.0
        self.speed = dir_speed * math.hypot(new[0] - self.x, new[1] - self.y)
        self.x, self.y, self.yaw = float(new[0]), float(new[1]), float(new[2])

    def __sub__(self, other_state: "RobotState") -> "RobotState":
        """Componentwise state difference (reference ``models.py:298-313``)."""
        return RobotState(
            x=self.x - other_state.x,
            y=self.y - other_state.y,
            yaw=self.yaw - other_state.yaw,
            speed=self.speed - other_state.speed,
        )

    def __abs__(self) -> float:
        """Planar distance from the origin (reference ``models.py:332-339``)."""
        return float(np.sqrt(self.x**2 + self.y**2))

    def distance(self, other_state) -> float:
        """Euclidean distance between two states (reference
        ``models.py:388-404``)."""
        if not isinstance(other_state, RobotState):
            raise TypeError(
                "Cannot get distance between robot state and type"
                f" '{type(other_state)}'"
            )
        return abs(self - other_state)

    def front_state_from_center_state(self, robot_radius: float) -> "RobotState":
        """State of the robot front point (at radius/2 along the heading)
        from the center state; mutates and returns self like the reference
        (``models.py:406-436``). Intentional divergence: the reference
        routes this through ``from_frame1_to_frame2_2d``, whose frame
        composition is inverted upstream (it calls
        ``get_relative_pose(frame1_in_2, target_in_1)``, i.e. maps the
        local point through the INVERSE robot pose); the correct forward
        composition is used here."""
        self.x = self.x + (robot_radius / 2.0) * math.cos(self.yaw)
        self.y = self.y + (robot_radius / 2.0) * math.sin(self.yaw)
        return self

    def set_from_yaml(self, path_to_file: str) -> None:
        """Load the initial state from a yaml file's 'robot' section
        (reference ``models.py:270-287``)."""
        from ..utils.common import set_params_from_yaml

        set_params_from_yaml(
            self,
            path_to_file,
            param_names=[
                ("robot_initial_x", "x"),
                ("robot_initial_y", "y"),
                ("robot_initial_heading", "yaw"),
                ("robot_initial_speed", "speed"),
            ],
            root_name="robot",
        )


@define
class LinearCtrlLimits(BaseAttrs):
    """Forward/lateral velocity limits (m/s, m/s^2)."""

    max_vel: float = field(default=1.0)
    max_acc: float = field(default=10.0)
    max_decel: float = field(default=10.0)
    min_absolute_val: float = field(default=0.01)


@define
class AngularCtrlLimits(BaseAttrs):
    """Angular velocity limits (rad/s, rad/s^2) and max steering angle."""

    max_vel: float = field(default=1.0)
    max_acc: float = field(default=10.0)
    max_decel: float = field(default=10.0)
    max_steer: float = field(default=math.pi)
    min_absolute_val: float = field(default=0.01)


@define
class RobotCtrlLimits(BaseAttrs):
    """Full control-limit set (vx, vy, omega)."""

    vx_limits: LinearCtrlLimits = field(default=Factory(LinearCtrlLimits))
    omega_limits: AngularCtrlLimits = field(default=Factory(AngularCtrlLimits))
    # reference default (models.py:1223-1232): lateral limits ZERO — an
    # Ackermann/diff-drive assumption; omni robots must opt in to vy
    vy_limits: LinearCtrlLimits = field(
        default=Factory(
            lambda: LinearCtrlLimits(max_vel=0.0, max_acc=0.0, max_decel=0.0)
        )
    )

    def to_array(self) -> np.ndarray:
        """Flat float32 array consumed by the device solver:
        [vx_max, vx_acc, vx_dec, vy_max, vy_acc, vy_dec, w_max, w_acc, w_dec].
        """
        return np.array(
            [
                self.vx_limits.max_vel,
                self.vx_limits.max_acc,
                self.vx_limits.max_decel,
                self.vy_limits.max_vel,
                self.vy_limits.max_acc,
                self.vy_limits.max_decel,
                self.omega_limits.max_vel,
                self.omega_limits.max_acc,
                self.omega_limits.max_decel,
            ],
            dtype=np.float32,
        )


@define
class Robot:
    """Aggregate of kinematic type, geometry and current state/control."""

    robot_type: RobotType = field(
        default=RobotType.DIFFERENTIAL_DRIVE, converter=RobotType.from_str
    )
    geometry_type: RobotGeometry.Type = field(
        default=RobotGeometry.Type.CYLINDER, converter=RobotGeometry.Type.from_str
    )
    geometry_params: np.ndarray = field(
        default=Factory(lambda: np.array([0.2, 0.5]))
    )
    state: RobotState = field(default=Factory(RobotState))
    ctrl_vx: float = field(default=0.0)
    ctrl_vy: float = field(default=0.0)
    ctrl_omega: float = field(default=0.0)

    control: Optional["MotionControl"] = field(init=False, default=None)

    @geometry_params.validator
    def _check_geometry(self, _attr, value):
        if not RobotGeometry.is_valid_parameters(self.geometry_type, value):
            raise ValueError(
                f"Invalid geometry parameters {value} for {self.geometry_type}"
            )

    def __attrs_post_init__(self):
        # per-type kinematic control holder, as the reference constructs in
        # its post-init (``models.py:1294-1307``)
        wheel_base = RobotGeometry.get_wheelbase(
            self.geometry_type, self.geometry_params
        )
        if self.robot_type == RobotType.DIFFERENTIAL_DRIVE:
            self.control = DifferentialDriveControl.init_zero(wheel_base)
        elif self.robot_type == RobotType.ACKERMANN:
            self.control = AckermannControl.init_zero(wheel_base)
        else:
            self.control = OmniControl.init_zero(wheel_base=wheel_base)

    @property
    def wheelbase(self) -> float:
        return RobotGeometry.get_wheelbase(self.geometry_type, self.geometry_params)

    @property
    def radius(self) -> float:
        return RobotGeometry.get_radius(self.geometry_type, self.geometry_params)

    @property
    def height(self) -> float:
        """Robot height from the geometry (reference ``models.py:1324-1336``)."""
        return RobotGeometry.get_height(self.geometry_type, self.geometry_params)

    @property
    def footprint(self):
        """2D footprint from the geometry (reference ``models.py:1344-1351``)."""
        return RobotGeometry.get_footprint(self.geometry_type, self.geometry_params)

    def set_state(self, x: float, y: float, yaw: float, speed: float) -> None:
        """Update the robot pose + speed (reference ``models.py:1353-1372``)."""
        self.state.x = float(x)
        self.state.y = float(y)
        self.state.yaw = float(yaw)
        self.state.speed = float(speed)

    def set_model(self, motion_model: MotionModel2D) -> None:
        """Swap the state's kinematic model (reference ``models.py:1381-1388``)."""
        self.state.model = motion_model

    def set_control(
        self, velocity_x: float = 0.0, velocity_y: float = 0.0, omega: float = 0.0
    ) -> None:
        self.ctrl_vx = float(velocity_x)
        self.ctrl_vy = float(velocity_y)
        self.ctrl_omega = float(omega)

    def get_state(self, dt: float) -> RobotState:
        """Apply the last set control for ``dt`` seconds and return the
        updated state (mirrors the reference test-sim contract)."""
        self.state.simulate(self.ctrl_vx, self.ctrl_omega, dt, v_y=self.ctrl_vy)
        self.state.vx = self.ctrl_vx
        self.state.vy = self.ctrl_vy
        self.state.omega = self.ctrl_omega
        return self.state


class MotionControl:
    """Kinematic control conversion base (role of the reference's
    ``MotionControl`` family, ``models.py:883-1194``): maps a body-frame
    velocity command (vx, vy, omega) to actuator-space quantities."""

    def __init__(
        self,
        velocity_x: float = 0.0,
        velocity_y: float = 0.0,
        omega: float = 0.0,
        wheel_base: float = 0.3,
    ):
        self.vx = float(velocity_x)
        self.vy = float(velocity_y)
        self.omega = float(omega)
        self.wheel_base = float(wheel_base)

    def update_ctr(self, *, omega: float, velocity_x: float, velocity_y: float = 0.0):
        self.vx = float(velocity_x)
        self.vy = float(velocity_y)
        self.omega = float(omega)

    # reference property surface (``models.py:919-967``)
    @property
    def linear_velocity_x(self) -> float:
        return self.vx

    @linear_velocity_x.setter
    def linear_velocity_x(self, value) -> None:
        self.vx = float(value)

    @property
    def linear_velocity_y(self) -> float:
        return self.vy

    @linear_velocity_y.setter
    def linear_velocity_y(self, value) -> None:
        self.vy = float(value)

    @property
    def angular_velocity(self) -> float:
        return self.omega

    @angular_velocity.setter
    def angular_velocity(self, value) -> None:
        self.omega = float(value)


class DifferentialDriveControl(MotionControl):
    """Body command -> left/right wheel linear speeds."""

    @classmethod
    def init_zero(cls, wheel_base: float) -> "DifferentialDriveControl":
        """Zero command (reference ``models.py:1013-1021``)."""
        return cls(0.0, 0.0, 0.0, wheel_base=wheel_base)

    @property
    def left_wheel_speed(self) -> float:
        return self.vx - self.omega * self.wheel_base / 2.0

    @property
    def right_wheel_speed(self) -> float:
        return self.vx + self.omega * self.wheel_base / 2.0

    # reference names (``models.py:1034-1058``; the reference's own
    # implementations hit a name-mangled attribute of the base class and
    # raise — the intended differential-drive kinematics are used here)
    v_left = left_wheel_speed
    v_right = right_wheel_speed

    def from_wheel_speeds(self, left: float, right: float):
        self.vx = (left + right) / 2.0
        self.omega = (right - left) / self.wheel_base
        return self


class AckermannControl(MotionControl):
    """Body command -> bicycle-model steering angle."""

    @classmethod
    def init_zero(cls, wheel_base: float) -> "AckermannControl":
        """Zero command (reference ``models.py:1078-1086``)."""
        return cls(0.0, 0.0, 0.0, wheel_base=wheel_base)

    @property
    def linear_vel(self) -> float:
        """Forward velocity (reference ``models.py:1099-1107``)."""
        return self.vx

    @property
    def steering_angle(self) -> float:
        if abs(self.vx) < 1e-9:
            return 0.0
        return math.atan(self.omega * self.wheel_base / self.vx)

    def from_steering(self, velocity_x: float, steering_angle: float):
        self.vx = float(velocity_x)
        self.omega = (
            math.tan(steering_angle) * velocity_x / self.wheel_base
        )
        return self


class OmniControl(MotionControl):
    """Holonomic base: body command -> wheel speeds of a 4-wheel mecanum
    base (+-45 deg rollers, square footprint of half-diagonal wheel_base).
    Exported as ``OmniDirectionalControl`` for the reference name
    (``models.py:1109-1135``)."""

    @classmethod
    def init_zero(cls, **kwargs) -> "OmniControl":
        """Zero command (reference ``models.py:1129-1135``)."""
        return cls(0.0, 0.0, 0.0, **kwargs)

    @property
    def wheel_speeds(self):
        l = self.wheel_base / 2.0
        return (
            self.vx - self.vy - l * self.omega,
            self.vx + self.vy + l * self.omega,
            self.vx + self.vy - l * self.omega,
            self.vx - self.vy + l * self.omega,
        )


def restrict_velocity_to_limits(
    current_velocity: float,
    target_velocity: float,
    acceleration_limit: float,
    deceleration_limit: float,
    max_vel: float,
    time_step: float,
) -> float:
    """Trapezoidal velocity limiting (reference ``controller.cpp:59-84``)."""
    cmd = current_velocity
    if current_velocity < target_velocity:
        cmd = min(current_velocity + acceleration_limit * time_step, target_velocity)
    elif current_velocity > target_velocity:
        cmd = max(current_velocity - deceleration_limit * time_step, target_velocity)
    return max(-max_vel, min(max_vel, cmd))
