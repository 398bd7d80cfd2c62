"""The ``omniack`` scene: the ``disc`` scene's grid, scan pool, restarts
and closed loop, with paths made for a fleet of omni and Ackermann
robots (``robot.kinds`` of the configuration, robot i of kind i % len).

An omni robot's 10 m path runs straight at ``offset_lo``-``offset_hi``
rad (either side) to its starting heading, below the follower's 1 rad
rotate-in-place threshold, so it takes the path sideways: its winners
carry vy. Every other robot keeps the ``disc`` path: it starts aligned
with it, and the path bends once halfway by up to ``bend`` rad, so an
Ackermann robot never needs to turn in place.
"""

import numpy as np

from . import disc


class Scene(disc.Scene):
    """The ``disc`` scene with the omni robots' paths turned off their
    headings."""

    def __init__(self, traffic: dict, cfg: dict, seed: int):
        super().__init__(traffic, cfg, seed)
        kinds = cfg["robot"]["kinds"]
        omni = np.array([kinds[i % len(kinds)]["drive"] == "OMNI" for i in range(self.n)])
        rng = np.random.default_rng([int(seed), 3])
        offset = rng.uniform(traffic["offset_lo"], traffic["offset_hi"], self.n)
        offset *= rng.choice((-1.0, 1.0), self.n)
        length = float(traffic["path_length"])
        for i in np.flatnonzero(omni):
            p0 = self.start[i, 0:2].astype(np.float64)
            heading = float(self.start[i, 2]) + offset[i]
            u = np.array([np.cos(heading), np.sin(heading)])
            self.paths[i] = np.stack([p0, p0 + 0.5 * length * u, p0 + length * u])
