"""Vision tracking datatypes.

Equivalents of the reference's ``datatypes/tracking.h:13-286``: 2D/3D
bounding boxes, points of interest, tracked boxes with velocity/acceleration
state, and the planar tracked pose. NumPy storage.
"""

import math

import numpy as np
from attrs import Factory, define, field


@define
class PointsOfInterest:
    """2D image points group (``tracking.h:13-53``)."""

    points_2d: np.ndarray = field(
        default=Factory(lambda: np.zeros((0, 2), dtype=np.int32))
    )
    timestamp: float = field(default=0.0)
    label: str = field(default="")
    img_size: np.ndarray = field(
        default=Factory(lambda: np.array([640, 480], dtype=np.int32))
    )
    vel: np.ndarray = field(default=Factory(lambda: np.zeros(2, dtype=np.int32)))

    def __attrs_post_init__(self):
        self.points_2d = np.asarray(self.points_2d, dtype=np.int32).reshape(-1, 2)
        if self.img_size[0] <= 0 or self.img_size[1] <= 0:
            raise ValueError("Invalid image size")
        for p in self.points_2d:
            if not (0 <= p[0] < self.img_size[0] and 0 <= p[1] < self.img_size[1]):
                raise ValueError(f"Point {p} is out of image bounds")

    def set_img_size(self, size):
        size = np.asarray(size, dtype=np.int32)
        if size[0] <= 0 or size[1] <= 0:
            raise ValueError("Invalid image size")
        self.img_size = size

    def set_vel(self, vel):
        """Set the tracked velocity (reference
        ``bindings_types.cpp:201``)."""
        self.vel = np.asarray(vel)


@define
class Bbox2D:
    """Axis-aligned 2D bounding box in image coordinates
    (``tracking.h:55-143``)."""

    top_left_corner: np.ndarray = field(
        default=Factory(lambda: np.zeros(2, dtype=np.int32))
    )
    size: np.ndarray = field(default=Factory(lambda: np.zeros(2, dtype=np.int32)))
    timestamp: float = field(default=0.0)
    label: str = field(default="")
    img_size: np.ndarray = field(
        default=Factory(lambda: np.array([640, 480], dtype=np.int32))
    )
    vel: np.ndarray = field(default=Factory(lambda: np.zeros(3, dtype=np.float32)))

    def __attrs_post_init__(self):
        self.top_left_corner = np.asarray(self.top_left_corner, dtype=np.int32)
        self.size = np.asarray(self.size, dtype=np.int32)

    @classmethod
    def from_points_of_interest(
        cls, poi: PointsOfInterest, mad_scale: float = 2.0
    ) -> "Bbox2D":
        """MAD-bounded box around the POI median (``tracking.h:82-121``)."""
        if len(poi.points_2d) == 0:
            raise ValueError("PointsOfInterest has no points")
        xs = np.sort(poi.points_2d[:, 0])
        ys = np.sort(poi.points_2d[:, 1])
        median_x = int(xs[len(xs) // 2])
        median_y = int(ys[len(ys) // 2])
        mad_x = int(np.sort(np.abs(xs - median_x))[len(xs) // 2])
        mad_y = int(np.sort(np.abs(ys - median_y))[len(ys) // 2])
        half_w = max(int(mad_scale * mad_x), 5)
        half_h = max(int(mad_scale * mad_y), 5)
        x0 = max(0, median_x - half_w)
        y0 = max(0, median_y - half_h)
        x1 = min(int(poi.img_size[0]) - 1, median_x + half_w)
        y1 = min(int(poi.img_size[1]) - 1, median_y + half_h)
        return cls(
            top_left_corner=np.array([x0, y0]),
            size=np.array([x1 - x0, y1 - y0]),
            timestamp=poi.timestamp,
            label=poi.label,
            img_size=poi.img_size.copy(),
        )

    def get_x_limits(self):
        return np.array(
            [self.top_left_corner[0], self.top_left_corner[0] + self.size[0]]
        )

    def get_y_limits(self):
        return np.array(
            [self.top_left_corner[1], self.top_left_corner[1] + self.size[1]]
        )

    def get_center(self):
        return self.top_left_corner + self.size // 2

    def set_img_size(self, size):
        size = np.asarray(size, dtype=np.int32)
        if size[0] <= 0 or size[1] <= 0:
            raise ValueError("Invalid image size")
        self.img_size = size

    def set_vel(self, vel):
        self.vel = np.asarray(vel, dtype=np.float32)


@define
class Bbox3D:
    """3D bounding box with its 2D image-frame footprint
    (``tracking.h:145-196``)."""

    center: np.ndarray = field(default=Factory(lambda: np.zeros(3, np.float32)))
    size: np.ndarray = field(default=Factory(lambda: np.zeros(3, np.float32)))
    center_img_frame: np.ndarray = field(
        default=Factory(lambda: np.zeros(2, np.int32))
    )
    size_img_frame: np.ndarray = field(
        default=Factory(lambda: np.zeros(2, np.int32))
    )
    pc_points: np.ndarray = field(
        default=Factory(lambda: np.zeros((0, 3), np.float32))
    )
    timestamp: float = field(default=0.0)
    label: str = field(default="")

    @classmethod
    def from_2d(cls, box2d: Bbox2D) -> "Bbox3D":
        return cls(
            center_img_frame=box2d.get_center().astype(np.int32),
            size_img_frame=box2d.size.astype(np.int32),
            timestamp=box2d.timestamp,
            label=box2d.label,
        )

    def get_x_limits_img(self):
        return np.array(
            [
                self.center_img_frame[0] - self.size_img_frame[0] / 2,
                self.center_img_frame[0] + self.size_img_frame[0] / 2,
            ]
        )

    def get_y_limits_img(self):
        return np.array(
            [
                self.center_img_frame[1] - self.size_img_frame[1] / 2,
                self.center_img_frame[1] + self.size_img_frame[1] / 2,
            ]
        )


@define
class TrackedPose2D:
    """Planar pose + velocity of a tracked target
    (``datatypes/control.h:142-188``)."""

    x: float = field(default=0.0)
    y: float = field(default=0.0)
    yaw: float = field(default=0.0)
    vx: float = field(default=0.0)
    vy: float = field(default=0.0)
    omega: float = field(default=0.0)

    def v(self) -> float:
        return math.hypot(self.vx, self.vy)

    def z(self) -> float:
        return self.yaw

    def update(self, dt: float):
        # reference quirk kept verbatim (control.h:165-172): the
        # integration rotates (vx, vy) by yaw as BODY-frame velocities,
        # but the tracker feeds WORLD-frame Kalman velocities with
        # yaw = atan2(vy, vx) (tracking.h getTrackedPose) — a target
        # moving diagonally is simulated veering off its true course
        # within each prediction horizon; every real tick re-anchors it
        c, s = math.cos(self.yaw), math.sin(self.yaw)
        self.x += (self.vx * c - self.vy * s) * dt
        self.y += (self.vx * s + self.vy * c) * dt
        self.yaw += self.omega * dt

    def distance(self, x: float, y: float, z: float = 0.0) -> float:
        return math.sqrt((self.x - x) ** 2 + (self.y - y) ** 2 + z * z)


@define
class TrackedBbox3D:
    """3D box + finite-difference velocity/acceleration
    (``tracking.h:198-284``)."""

    box: Bbox3D = field(default=Factory(Bbox3D))
    vel: np.ndarray = field(default=Factory(lambda: np.zeros(3, np.float32)))
    acc: np.ndarray = field(default=Factory(lambda: np.zeros(3, np.float32)))
    unique_id: int = field(default=0)

    def yaw(self) -> float:
        return math.atan2(self.vel[1], self.vel[0])

    def omega(self) -> float:
        return 0.0

    def ang_acc(self) -> float:
        return 0.0

    def v(self) -> float:
        return math.hypot(self.vel[0], self.vel[1])

    def update_from_new_detection(self, new_box: Bbox3D) -> None:
        """Finite-difference vel/acc update (``tracking.h:216-236``)."""
        if new_box.label != self.box.label:
            return
        dt = new_box.timestamp - self.box.timestamp
        if dt <= 0.0:
            self.vel = np.zeros(3, np.float32)
            self.acc = np.zeros(3, np.float32)
        else:
            new_vel = (new_box.center - self.box.center) / dt
            self.acc = (new_vel - self.vel) / dt
            self.vel = new_vel
        self.box = new_box

    def predict_constant_acc(self, dt: float) -> "TrackedBbox3D":
        out = TrackedBbox3D(
            box=Bbox3D(
                center=self.box.center.copy(),
                size=self.box.size.copy(),
                center_img_frame=self.box.center_img_frame.copy(),
                size_img_frame=self.box.size_img_frame.copy(),
                pc_points=self.box.pc_points,
                timestamp=self.box.timestamp + dt,
                label=self.box.label,
            ),
            vel=self.vel + self.acc * dt,
            acc=self.acc.copy(),
            unique_id=self.unique_id,
        )
        # reference quirk kept verbatim (tracking.h:247-253): the center
        # advances by (vel + acc*dt)*dt — i.e. vel*dt + acc*dt^2, not the
        # kinematic vel*dt + 0.5*acc*dt^2
        out.box.center = self.box.center + out.vel * dt
        return out

    def get_tracked_pose(self) -> TrackedPose2D:
        return TrackedPose2D(
            x=float(self.box.center[0]),
            y=float(self.box.center[1]),
            yaw=self.yaw(),
            vx=float(self.vel[0]),
            vy=float(self.vel[1]),
            omega=0.0,
        )
