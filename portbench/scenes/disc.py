"""The ``disc`` scene: independent robots, each on its own gently bent
10 m path (one bend of up to ``bend`` rad halfway), laid out on a grid.

Every call hands the fleet a scan from a pool made at set-up: uniform
``range_lo``-``range_hi`` m returns, and in ``arc_share`` of the robots
an arc of ``arc_rays`` rays straight ahead at ``arc_lo``-``arc_hi`` m.
States advance by the returned commands (or to the k-tick call's final
states). Every ``episode_ticks`` ticks each robot goes back to its start
with a fresh seeded offset, long before any reaches the path's last
segment, so every robot keeps driving and the work per call stays the
same.
"""

import math

import numpy as np

from . import step


class Scene:
    """A scene gives the loop ``n`` robots with ``k`` ticks per call,
    the scan ``angles``, the ``paths``, and per call ``inputs()`` and
    ``advance(out)``."""

    def __init__(self, traffic: dict, cfg: dict, seed: int):
        rng = np.random.default_rng(seed)
        self.n = n = int(traffic["robots"])
        self.k = int(traffic.get("k", 1))
        self.dt = float(cfg["dwa"]["control_time_step"])
        R = int(cfg["scan_rays"])
        self.angles = np.linspace(-np.pi, np.pi, R, endpoint=False).astype(np.float32)
        cols = int(math.ceil(math.sqrt(n)))
        spacing = float(traffic["spacing"])
        self.start = np.zeros((n, 4), np.float32)
        self.start[:, 0] = spacing * (np.arange(n) % cols)
        self.start[:, 1] = spacing * (np.arange(n) // cols)
        heading = rng.uniform(-np.pi, np.pi, n)
        self.start[:, 2] = heading
        bend = rng.uniform(-traffic["bend"], traffic["bend"], n)
        half = 0.5 * float(traffic["path_length"])
        p0 = self.start[:, 0:2].astype(np.float64)
        p1 = p0 + half * np.stack([np.cos(heading), np.sin(heading)], 1)
        p2 = p1 + half * np.stack([np.cos(heading + bend), np.sin(heading + bend)], 1)
        self.paths = [np.stack([p0[i], p1[i], p2[i]]) for i in range(n)]
        # the scan pool: every call takes one entry, in a seeded order
        P = int(traffic["pool"])
        lo, hi = float(traffic["range_lo"]), float(traffic["range_hi"])
        self.pool = rng.uniform(lo, hi, (P, n, R)).astype(np.float32)
        arc = int(traffic["arc_rays"])
        ahead = R // 2 - arc // 2
        for p in range(P):
            near = rng.random(n) < float(traffic["arc_share"])
            self.pool[p, near, ahead:ahead + arc] = rng.uniform(
                traffic["arc_lo"], traffic["arc_hi"], (int(near.sum()), arc))
        self.order = rng.integers(0, P, 1 << 16)
        self.jitter = float(traffic["jitter"])
        self.episode = int(traffic["episode_ticks"])
        self.rng = rng
        self.tick = 0
        self.call = 0
        self._restart()

    def _restart(self):
        self.states = self.start.copy()
        j = self.rng.uniform(-self.jitter, self.jitter, (self.n, 3)).astype(np.float32)
        self.states[:, 0:3] += j
        self.vels = np.zeros((self.n, 3), np.float32)

    def inputs(self):
        ranges = self.pool[self.order[self.call % len(self.order)]]
        return self.states, self.vels, ranges, None

    def advance(self, out):
        self.call += 1
        if self.k == 1:
            cmd = [out[f].astype(np.float32) for f in ("vx", "vy", "omega")]
            step(self.states, *cmd, self.dt)
            self.vels = np.stack(cmd, 1)
        else:
            self.states = out["final_states"].astype(np.float32).copy()
            self.vels = np.stack([out[f][:, -1] for f in ("vx", "vy", "omega")],
                                 1).astype(np.float32)
        self.tick += self.k
        if self.tick % self.episode == 0:
            self._restart()
