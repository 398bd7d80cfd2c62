"""Robot footprint classes (reference ``models.py:439-656``).

Plot-capable circular/rectangular footprints with YAML loading via
``utils.common.set_params_from_yaml`` — offline visualization and
config helpers; the solver's collision model consumes robot geometry
directly (circle via calibrated margin, BOX via
``SolverSpec.collision_box``).
"""

import math
from typing import Optional

import numpy as np

from ..utils.common import set_params_from_yaml
from .robot import RobotState


class CircularFootprint:
    """Circular footprint (reference ``models.py:439-536``)."""

    def __init__(self, rad: float = 1.0,
                 robot_state: Optional[RobotState] = None):
        self.radius = rad
        self.wheel_base = rad
        state = robot_state or RobotState()
        self.center = np.array([state.x, state.y])

    def set_from_yaml(self, path_to_file: str) -> None:
        set_params_from_yaml(
            self,
            path_to_file,
            param_names=[("robot_radius", "radius")],
            root_name="robot",
        )

    def get_radius(self) -> float:
        return self.radius

    def plt_robot(self, x, y, heading, color="blue", ax=None) -> None:
        """Draw the body disc + front wheel discs + center marker."""
        import matplotlib.pyplot as plt
        from matplotlib.patches import Circle

        ax = ax or plt.gca()
        dx, dy = math.cos(heading), math.sin(heading)
        ax.add_patch(Circle((x, y), self.radius, color=color, alpha=0.5))
        r = self.radius
        for side in (+1, -1):
            wx = x + (r / 2) * dx - side * (2 * r / 3) * dy
            wy = y + (r / 2) * dy + side * (2 * r / 3) * dx
            ax.add_patch(Circle((wx, wy), r / 4, color="black"))
        ax.plot(x, y, "b+")


class RectangleFootprint:
    """Rectangular footprint (reference ``models.py:538-652``)."""

    def __init__(self, width: float = 1.0, length: float = 2.0):
        self.width = width
        self.length = length
        self.wheel_base = width

    def set_from_yaml(self, path_to_file: str) -> None:
        set_params_from_yaml(
            self,
            path_to_file,
            param_names=[
                ("robot_width", "width"),
                ("robot_length", "length"),
            ],
            root_name="robot",
        )

    def get_radius(self) -> float:
        """Radius of the circumscribing circle."""
        return math.hypot(self.length / 2, self.width / 2)

    def plt_robot(self, x, y, heading, color="blue", ax=None) -> None:
        """Draw the oriented body rectangle + center marker."""
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle
        from matplotlib.transforms import Affine2D

        ax = ax or plt.gca()
        rect = Rectangle(
            (x - self.length / 2, y - self.width / 2),
            self.length,
            self.width,
            color=color,
            alpha=0.5,
        )
        rect.set_transform(
            Affine2D().rotate_around(x, y, heading) + ax.transData
        )
        ax.add_patch(rect)
        ax.plot(x, y, "b+")


footprint_types = [CircularFootprint, RectangleFootprint]
