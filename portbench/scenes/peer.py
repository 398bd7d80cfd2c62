"""The ``peer`` scene: the shared-floor scene of 16 groups of 4 robots,
25 m apart.

Each group has a head-on pair on one line, and in even groups a crossing
pair, in odd groups two robots driving at a wall across their paths; the
last robot is boxed in (every return at 0.5 m). Every robot has one
live mover in slot 0 of its tracked slots, walking past at 0.5 m/s.
Scans are cast against each robot's wall from its pose. States advance
by the returned commands. Every ``episode_ticks`` ticks the scene
restarts from its start poses with a fresh seeded offset of a few
centimetres, before any robot reaches its path's last segment (a robot
that had reached its goal would stay stopped). The output check always
judges the boxed-in robot (``check_always``).
"""

import numpy as np

from . import step


class Scene:
    # per role: path start, path end, start offset from the path (roles 4
    # and 5 unused; 6 and 7 the wall robots)
    START = np.array([[0.0, 0.0], [5.0, 0.03], [8.5, -2.5], [8.5, 2.5],
                      [0, 0], [0, 0], [14.0, 0.0], [17.0, 0.0]])
    GOAL = np.array([[5.0, 0.0], [0.0, 0.03], [13.5, 2.5], [13.5, -2.5],
                     [0, 0], [0, 0], [14.0, 4.0], [17.0, 4.0]])
    OFF = np.array([[0.0, 0.031], [0.0, 0.031], [0.022, -0.022], [0.022, 0.022],
                    [0, 0], [0, 0], [0.031, 0.0], [0.031, 0.0]])

    def __init__(self, traffic: dict, cfg: dict, seed: int):
        self.rng = np.random.default_rng(seed)
        self.n = n = int(traffic["robots"])
        self.k = int(traffic.get("k", 1))
        self.dt = float(cfg["dwa"]["control_time_step"])
        self.rays = int(cfg["scan_rays"])
        self.range_max = float(cfg["sensor_max_range"])
        self.tracked = int(cfg["tracked_obstacles"])
        self.angles = np.linspace(-np.pi, np.pi, self.rays, endpoint=False).astype(np.float32)
        gap = float(traffic["wall_gap"])
        self.wall_speed = float(traffic["wall_speed"])
        spacing = float(traffic["group_spacing"])
        g = np.arange(n) // 4
        role = np.arange(n) % 4 + 4 * (g % 2 == 1) * (np.arange(n) % 4 >= 2)
        origin = np.stack([spacing * (g % 4), spacing * (g // 4)], 1)
        start = self.START.copy()
        start[6:8, 1] = -gap
        self.path_start = origin + start[role]
        self.start_xy = self.path_start + self.OFF[role]
        d = self.GOAL[role] - start[role]
        self.start_yaw = np.arctan2(d[:, 1], d[:, 0])
        self.wall = role >= 6
        self.paths = [np.stack([self.path_start[i], origin[i] + self.GOAL[role[i]]])
                      for i in range(n)]
        self.walls = np.concatenate([origin + (8.0, 0.0), origin + (21.0, 0.0)], 1)
        self.walls[g % 2 == 0] = (0.0, 1e4, 1.0, 1e4)  # out of range
        self.boxed = n - 1
        self.check_always = (self.boxed,)
        self.mover_offset = np.array([-6.0, 0.0])
        self.mover_vel = np.array([0.0, 0.5])
        self.jitter = float(traffic["jitter"])
        self.episode = int(traffic["episode_ticks"])
        self.tick = 0
        self.call = 0
        self._restart()

    def _restart(self):
        j = self.rng.uniform(-self.jitter, self.jitter, (self.n, 2))
        self.states = np.zeros((self.n, 4), np.float32)
        self.states[:, 0:2] = self.start_xy + j
        self.states[:, 2] = self.start_yaw
        self.vels = np.zeros((self.n, 3), np.float32)
        self.states[self.wall, 3] = self.vels[self.wall, 0] = self.wall_speed
        self.movers = self.states[:, 0:2].astype(np.float64) + self.mover_offset

    def _cast(self):
        """Ranges from each robot's pose against its wall segment; no hit
        within range gives +inf."""
        s, walls = self.states, self.walls
        th = s[:, 2:3] + self.angles.astype(np.float64)
        dx, dy = np.cos(th), np.sin(th)
        ex = (walls[:, 2] - walls[:, 0])[:, None]
        ey = (walls[:, 3] - walls[:, 1])[:, None]
        ax = (walls[:, 0] - s[:, 0])[:, None]
        ay = (walls[:, 1] - s[:, 1])[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = dx * ey - dy * ex
            t = (ax * ey - ay * ex) / denom
            u = (ax * dy - ay * dx) / denom
        hit = (denom != 0.0) & (t > 0.0) & (u >= 0.0) & (u <= 1.0) & (t <= self.range_max)
        return np.where(hit, t, np.inf).astype(np.float32)

    def inputs(self):
        ranges = self._cast()
        ranges[self.boxed] = 0.5
        tracked = np.full((self.n, self.tracked, 4), np.nan, np.float32)
        tracked[:, 0, 0:2] = self.movers
        tracked[:, 0, 2:4] = self.mover_vel
        return self.states, self.vels, ranges, tracked

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
        self.movers += self.k * self.dt * self.mover_vel
        self.tick += self.k
        if self.tick % self.episode == 0:
            self._restart()
