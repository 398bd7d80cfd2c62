"""Plain PyTorch reference of one fleet control tick, for the benchmark's
output check.

It recomputes, from the inputs the benchmark made (the configuration
file, each robot's raw path points, states, velocities, scans, tracked
movers), what the fleet program derives and returns: the path tables
(interpolation, segmentation, padding), the configuration rows, the
critical-zone tables, the follower (goal and losing-goal detection,
sticky target determination, adaptive horizon, tracked-segment window),
the float32 dynamic window, the closed-form rollout, the obstacle and
segment min-distance fields (static, moving, oriented box), drop
admissibility, the goal, path and obstacle costs, the first-minimum
argmin, the rotate-in-place and reached overrides, peer discs with their
predicted motion and the safety gate (beam form for a single tick, world
form inside the k-tick loop).

It is a frozen copy of the function's operations, each written out in
plain tensor code: no kernel, no cache, no graph. It imports nothing of
the program. It handles what the benchmark's configurations use:
differential-drive robots, drop mode, circle or mixed circle and box
fleets, tracked movers in the scan bucket's tail slots, peers with or
without prediction, with or without the safety gate.

``dtype`` selects the float type of the solve (window, rollout, sweeps,
costs, obstacle and peer points); the follower's index arithmetic stays
as it is. float32 is the configuration's precision; the lower-precision
control of the output check runs the solve in bfloat16.
"""

import math

import numpy as np
import torch

PAD = 1e8
MIN_VEL = 0.01
COLLISION_MARGIN_FACTOR = 0.7
SLAB_ELEMS = 1 << 25  # elements of one [rows, S, T, O] slab of a sweep


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def sqrt_rn(x):
    """Correctly rounded float32 square root through float64."""
    if x.dtype != torch.float32:
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def div_t(x, divisor: float):
    """x / divisor as a true division by a tensor on every device."""
    return x / torch.full_like(x, divisor)


# ---------------------------------------------------------------------------
# host side: robot rows, paths, zone tables
# ---------------------------------------------------------------------------


def circumscribed_radius(geometry: str, params) -> float:
    """Cylinder radius, or a box's half diagonal."""
    if geometry == "BOX":
        return float(math.sqrt(params[0] ** 2 + params[1] ** 2) / 2.0)
    return float(params[0])


class Layout:
    """Every static size and per-robot row of one configuration at
    ``n_robots`` robots, worked out from the configuration file."""

    def __init__(self, cfg: dict, n_robots: int):
        if cfg["robot"]["drive"] != "DIFFERENTIAL_DRIVE":
            raise ValueError("the reference handles differential-drive robots")
        dwa = cfg["dwa"]
        if not dwa["drop_samples"]:
            raise ValueError("the reference handles drop mode")
        self.n = n_robots
        self.dt = float(dwa["control_time_step"])
        self.interp = float(dwa["max_point_interpolation_distance"])
        self.seg_length = float(dwa["path_segment_length"])
        n = n_robots
        n_lin = max(3, int(dwa["max_linear_samples"]))
        self.n_vx = n_lin + 1 if n_lin % 2 == 0 else n_lin
        self.n_vy = 1
        n_ang = dwa["max_angular_samples"]
        self.n_omega = n_ang + 1 - (n_ang % 2)
        self.S = self.n_vx * self.n_omega
        self.T = int(dwa["prediction_horizon"])
        self.ctrl_points = int(dwa["control_horizon"])
        self.rays = int(cfg["scan_rays"])
        self.tracked = int(cfg["tracked_obstacles"])
        self.scan_size = max(256, round_up(self.rays + self.tracked, 256))
        self.path_capacity = int(cfg["path_capacity"])
        self.max_segments = int(cfg["max_segments"])
        lim = cfg["limits"]
        vx_max = float(lim["vx"][0])
        base_h = dwa["prediction_horizon"] * self.dt
        lookahead = max(
            int(self.seg_length / self.interp) + 1,
            int(math.ceil(base_h * vx_max / self.interp)) + 1,
        )
        self.lookahead = lookahead
        self.seg_size = round_up(lookahead + 1, 64)
        self.max_seg_pts = int(self.seg_length / self.interp) + 1

        box_every = int(cfg["robot"].get("box_every", 0))
        self.is_box = np.array(
            [bool(box_every) and i % box_every == 0 for i in range(n)])
        self.has_box = bool(self.is_box.any())
        circle = cfg["robot"]["circle_params"]
        box = cfg["robot"].get("box_params")
        margin = float(dwa["octree_resolution"]) * COLLISION_MARGIN_FACTOR
        self.radius = np.zeros(n, np.float32)
        self.box2 = np.zeros((n, 2), np.float32)
        eff_margin = np.full(n, margin, np.float32)
        self.geometry = []
        for i in range(n):
            if self.is_box[i]:
                gp = np.asarray(box, np.float64)
                self.radius[i] = circumscribed_radius("BOX", gp)
                self.box2[i] = (gp[0] / 2.0, gp[1] / 2.0)
                self.geometry.append(("BOX", gp))
            else:
                gp = np.asarray(circle, np.float64)
                self.radius[i] = circumscribed_radius("CYLINDER", gp)
                if self.has_box:
                    eff_margin[i] = circumscribed_radius("CYLINDER", gp) + margin
                self.geometry.append(("CYLINDER", gp))

        row = np.array([lim["vx"][0], lim["vx"][1], lim["vx"][2], 0.0, 0.0, 0.0,
                        lim["omega"][0], lim["omega"][1], lim["omega"][2]], np.float32)
        self.limits9 = np.tile(row, (n, 1))
        w = dwa["weights"]
        self.params12 = np.zeros((n, 12), np.float32)
        for i in range(n):
            self.params12[i] = (
                self.dt, self.radius[i], eff_margin[i],
                w["reference_path_distance_weight"], w["goal_distance_weight"],
                w["obstacles_distance_weight"], w["smoothness_weight"],
                w["jerk_weight"], row[1], row[4], row[7],
                float(cfg["sensor_max_range"]) / 3.0,
            )

        def full(v, dt=np.float32):
            return np.full(n, v, dt)

        self.goal_tol = full(dwa["goal_dist_tolerance"])
        self.ori_tol = full(dwa["goal_orientation_tolerance"])
        self.losing_tol = full(dwa["loosing_goal_distance"])
        self.interp_row = full(self.interp)
        self.base_h = full(base_h)
        self.curv_tol = full(dwa["curvature_horizon_tolerance"])
        self.vx_max = full(vx_max)
        self.max_seg_size = full(self.max_seg_pts, np.int32)

        peers = cfg.get("peers")
        self.peers = None if not peers else dict(ring=int(peers["ring"]),
                                                  predict=bool(peers["predict"]))
        self.safety = cfg.get("safety")

    # --- paths (the program's host interpolation and segmentation) ---

    def path_row(self, pts):
        """One raw path -> padded (x, y, arc, curv, n_points, seg_starts,
        n_segs, total_len) rows: linear arc-length resampling at the
        interpolation distance, finite-difference curvature, segments by
        length and point count."""
        P = self.path_capacity
        cap = P + self.seg_size
        NS = self.max_segments
        pts = np.asarray(pts, np.float64)
        xs = pts[:, 0].astype(np.float32)
        ys = pts[:, 1].astype(np.float32)
        x64, y64 = xs.astype(np.float64), ys.astype(np.float64)
        s_vals = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x64), np.diff(y64)))])
        total = float(s_vals[-1])
        keep = np.concatenate([[True], np.diff(s_vals) > 1e-12])
        s_vals, x64, y64 = s_vals[keep], x64[keep], y64[keep]
        ds = self.interp
        n_new = int(total / ds) + 1
        sq = ds * np.arange(n_new)
        rx = np.interp(sq, s_vals, x64).astype(np.float32)
        ry = np.interp(sq, s_vals, y64).astype(np.float32)
        arc = sq.astype(np.float32)
        xd, yd = rx.astype(np.float64), ry.astype(np.float64)
        curv = np.zeros(n_new)
        if n_new >= 3:
            dx, dy = np.diff(xd), np.diff(yd)
            ddx, ddy = dx[1:] - dx[:-1], dy[1:] - dy[:-1]
            val = dx[1:] ** 2 + dy[1:] ** 2
            denom = val * np.sqrt(val)
            num = dx[:-1] * ddy - ddx * dy[:-1]
            with np.errstate(divide="ignore", invalid="ignore"):
                curv[1:-1] = np.where(denom > 1e-6, num / denom, 0.0)
        curv = curv.astype(np.float32)
        starts = [0]
        seg_start, seg_start_len = 0, arc[0]
        for i in range(1, n_new):
            if (arc[i] - seg_start_len >= self.seg_length
                    or i - seg_start + 1 > self.max_seg_pts):
                starts.append(i)
                seg_start, seg_start_len = i, arc[i]
        n = min(n_new, P)
        starts = np.asarray(starts, np.int64)
        if n_new > P:
            starts = starts[starts < n]
            total = float(arc[n - 1])
        x = np.full(cap, PAD, np.float32)
        y = np.full(cap, PAD, np.float32)
        a = np.zeros(cap, np.float32)
        c = np.zeros(cap, np.float32)
        x[:n], y[:n], a[:n], c[:n] = rx[:n], ry[:n], arc[:n], curv[:n]
        ns = max(min(len(starts), NS), 1)
        seg_starts = np.zeros(NS, np.int32)
        seg_starts[:ns] = starts[:ns]
        seg_starts[ns:] = n
        return x, y, a, c, n, seg_starts, ns, np.float32(total)

    # --- critical zone (the program's host preset) ---

    def zone_rows(self, angles):
        """Per robot: beam trig, forward and backward cone masks, sensor
        yaw trig, radius, critical and slowdown distances, half cone."""
        s = self.safety
        n, R = self.n, self.rays
        ang = np.asarray(angles, np.float32).astype(np.float64)
        ca, sa = np.cos(ang), np.sin(ang)
        half = (s["critical_angle_deg"] * math.pi / 180.0 / 2.0 + math.pi) % (2 * math.pi) - math.pi
        abs_theta = np.abs(np.arctan2(1.0 * sa + 0.0, 1.0 * ca - 0.0 * sa + 0.0))
        fwd = abs_theta <= half
        bwd = abs_theta >= math.pi - half
        return dict(
            cos_a=np.tile(ca.astype(np.float32), (n, 1)),
            sin_a=np.tile(sa.astype(np.float32), (n, 1)),
            fwd=np.tile(fwd, (n, 1)), bwd=np.tile(bwd, (n, 1)),
            sc=np.ones(n, np.float32), ss=np.zeros(n, np.float32),
            rad=np.array([circumscribed_radius(g, p) for g, p in self.geometry],
                         np.float32),
            crit=np.full(n, s["critical_distance"], np.float32),
            slow=np.full(n, s["slowdown_distance"], np.float32),
            half=np.full(n, half, np.float32),
        )


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------


def pick(rows, idx):
    idx = idx.long().clamp(0, rows.shape[-1] - 1)
    return rows.gather(-1, idx.unsqueeze(-1))[..., 0]


class FleetReference:
    """The reference fleet for the robots ``rows`` of an ``n``-robot
    fleet on ``device``: their path tables from the raw ``paths`` (one
    per fleet robot) and their follower carry."""

    def __init__(self, layout: Layout, rows, angles, paths, device):
        self.L = layout
        self.rows = np.asarray(rows, np.int64)
        self.device = dev = torch.device(device)
        B = len(self.rows)
        tables = [layout.path_row(paths[r]) for r in self.rows]

        def stack(i, dtype):
            return torch.tensor(np.stack([t[i] for t in tables]).astype(dtype), device=dev)

        self.paths = dict(
            x=stack(0, np.float32), y=stack(1, np.float32), arc=stack(2, np.float32),
            curv=stack(3, np.float32), n_points=stack(4, np.int32),
            seg_starts=stack(5, np.int32), n_segs=stack(6, np.int32),
            total=stack(7, np.float32),
        )
        self.carry = dict(
            closest=torch.zeros(B, dtype=torch.int32, device=dev),
            seg=torch.zeros(B, dtype=torch.int32, device=dev),
            pos=torch.full((B,), -1.0, device=dev),
            goal=torch.full((B,), math.inf, device=dev),
            reached=torch.zeros(B, dtype=torch.bool, device=dev),
        )
        self.angles = torch.tensor(np.tile(np.asarray(angles, np.float32), (B, 1)),
                                   device=dev)
        self.zone = None
        if layout.safety:
            z = layout.zone_rows(angles)
            self.zone = {k: torch.tensor(v[self.rows], device=dev) for k, v in z.items()}

        def t(a):
            return torch.tensor(a[self.rows], device=dev)

        self.params12, self.limits9 = t(layout.params12), t(layout.limits9)
        self.box2 = t(layout.box2)
        self.goal_tol, self.ori_tol = t(layout.goal_tol), t(layout.ori_tol)
        self.losing_tol, self.interp = t(layout.losing_tol), t(layout.interp_row)
        self.base_h, self.curv_tol = t(layout.base_h), t(layout.curv_tol)
        self.vx_max, self.max_seg_size = t(layout.vx_max), t(layout.max_seg_size)

    # --- follower ---

    def _seg_end(self, p, seg):
        ns = p["n_segs"]
        nxt = pick(p["seg_starts"], torch.minimum(seg + 1, ns - 1))
        return torch.where(seg + 1 < ns, nxt - 1, p["n_points"] - 1)

    def _descent(self, p, px, py):
        starts = p["seg_starts"].long().clamp(0, p["x"].shape[-1] - 1)
        dx = px.unsqueeze(-1) - p["x"].gather(-1, starts)
        dy = py.unsqueeze(-1) - p["y"].gather(-1, starts)
        start_d2 = dx * dx + dy * dy
        left = torch.zeros_like(p["n_segs"])
        right = torch.clamp(p["n_segs"] - 1, min=0)
        result = torch.zeros_like(left)
        done = right == left
        NS = p["seg_starts"].shape[-1]
        for _ in range(max(1, NS - 1).bit_length() + 2):
            mid = (left + right) // 2
            closer_left = pick(start_d2, left) <= pick(start_d2, right)
            at_edge = (mid == right) | (mid == left)
            chosen = torch.where(closer_left, left, right)
            result = torch.where(~done & at_edge, chosen, result)
            result = torch.where(~done & (left == right), left, result)
            done = done | at_edge | (left == right)
            new_right = torch.where(closer_left, mid, right)
            new_left = torch.where(closer_left, left, mid)
            left = torch.where(done, left, new_left)
            right = torch.where(done, right, new_right)
        return result

    def follow(self, states):
        """One follower step of the robots at ``states`` [B, 4] (float32,
        on the device): advances the carry and returns the plan the solve
        reads."""
        p = self.paths
        c = self.carry
        x, y, yaw = states[:, 0], states[:, 1], states[:, 2]
        L = p["x"].shape[-1]
        goal_i = p["n_points"] - 1
        gx, gy = pick(p["x"], goal_i), pick(p["y"], goal_i)
        d_goal = sqrt_rn((x - gx) * (x - gx) + (y - gy) * (y - gy))
        at_end = (c["seg"] + 1) >= (p["n_segs"] - 1)
        improving = d_goal < c["goal"]
        new_goal = torch.where(at_end & improving, d_goal, c["goal"])
        losing = at_end & ~improving & (torch.abs(d_goal - c["goal"]) > self.losing_tol)
        reached = c["reached"] | (d_goal <= self.goal_tol) | losing

        seg_end = self._seg_end(p, c["seg"])
        research = (c["pos"] <= 0.0) | (c["closest"] >= seg_end) | (c["pos"] >= 0.9)
        new_seg = torch.where(research, self._descent(p, x, y), c["seg"]).to(torch.int32)
        start_i = pick(p["seg_starts"], new_seg)
        end_i = self._seg_end(p, new_seg)
        j = torch.arange(L, device=x.device)
        in_seg = (j >= start_i.unsqueeze(-1)) & (j <= end_i.unsqueeze(-1))
        dx = x.unsqueeze(-1) - p["x"]
        dy = y.unsqueeze(-1) - p["y"]
        d2 = torch.where(in_seg, dx * dx + dy * dy, math.inf)
        m = torch.amin(d2, dim=-1)
        cidx = torch.amax(torch.where(d2 <= m.unsqueeze(-1), j, -1), dim=-1).to(torch.int32)
        seg_size = end_i - start_i + 1
        pos = torch.where(seg_size > 1,
                          (cidx - start_i).to(torch.float32) / torch.clamp(seg_size - 1, min=1),
                          1.0)
        sx, sy = pick(p["x"], start_i), pick(p["y"], start_i)
        ex, ey = pick(p["x"], end_i), pick(p["y"], end_i)
        heading = torch.atan2(ey - sy, ex - sx)
        heading_error = torch.remainder(heading - yaw + math.pi, 2 * math.pi) - math.pi

        dt = self.params12[:, 0]
        peek = torch.ceil(self.base_h * self.vx_max / self.interp).to(torch.int32)
        start = torch.minimum(cidx, p["n_points"] - 1)
        peek_end = torch.minimum(start + peek, p["n_points"] - 1)
        in_peek = (j >= start.unsqueeze(-1)) & (j <= peek_end.unsqueeze(-1))
        kappa = torch.amax(torch.where(in_peek, torch.abs(p["curv"]), 0.0), dim=-1)
        cap = sqrt_rn(8.0 * self.curv_tol / torch.clamp(kappa, min=1e-9)) / torch.clamp(
            self.vx_max, min=1e-3)
        adaptive = torch.where(kappa > self.curv_tol, torch.minimum(self.base_h, cap),
                               self.base_h)
        horizon = torch.minimum(torch.maximum(adaptive, 2.0 * dt), self.base_h)
        active = torch.clamp((horizon / dt).to(torch.int32), 2, self.L.T)
        max_forward = adaptive * self.vx_max

        G = self.L.seg_size
        lookahead = torch.maximum(
            self.max_seg_size, torch.ceil(max_forward / self.interp).to(torch.int32) + 1)
        end = torch.minimum(start + lookahead, p["n_points"] - 1)
        seg_count = torch.clamp(end - start + 1, max=G)
        k = torch.arange(G, device=x.device)
        idx = start.long().clamp(0, L - G).unsqueeze(-1) + k
        seg_x_raw = p["x"].gather(-1, idx)
        seg_y_raw = p["y"].gather(-1, idx)
        seg_arc = p["arc"].gather(-1, idx)
        in_window = k < seg_count.unsqueeze(-1)
        seg_x = torch.where(in_window, seg_x_raw, PAD)
        seg_y = torch.where(in_window, seg_y_raw, PAD)
        cdx = seg_x_raw[:, 1:] - seg_x_raw[:, :-1]
        cdy = seg_y_raw[:, 1:] - seg_y_raw[:, :-1]
        chords = torch.sqrt(cdx * cdx + cdy * cdy)
        seg_total = torch.where(in_window[:, 1:], chords, 0.0).sum(-1)

        self.carry = dict(closest=cidx, seg=new_seg, pos=pos, goal=new_goal,
                          reached=reached)
        return dict(reached=reached, heading_error=heading_error, active=active,
                    seg_x=seg_x, seg_y=seg_y, seg_arc=seg_arc, seg_count=seg_count,
                    seg_total=seg_total, ref_total=p["total"])

    # --- obstacles ---

    def scan_world(self, ranges, states, dtype=torch.float32):
        """Scans [B, R] -> [B, scan_size, 2] world points at ``states``."""
        ang = self.angles.to(dtype)
        r = torch.where(torch.isfinite(ranges), ranges, PAD).to(dtype)
        pxs = r * torch.cos(ang)
        pys = r * torch.sin(ang)
        z = torch.zeros_like(states[:, 0:1]).to(dtype)
        cs, ss = torch.cos(z), torch.sin(z)
        bx = cs * pxs - ss * pys + z
        by = ss * pxs + cs * pys + z
        st = states.to(dtype)
        cy = torch.cos(st[:, 2]).unsqueeze(-1)
        sy = torch.sin(st[:, 2]).unsqueeze(-1)
        obs = torch.stack([cy * bx - sy * by + st[:, 0].unsqueeze(-1),
                           sy * bx + cy * by + st[:, 1].unsqueeze(-1)], dim=-1)
        B, R = ranges.shape
        if R < self.L.scan_size:
            obs = torch.cat([obs, obs.new_full((B, self.L.scan_size - R, 2), PAD)], 1)
        return obs

    def peer_rows(self, all_states, all_vels, dtype=torch.float32):
        """Every sampled robot's peer rows [B, N * (ring + 1), 2] (its own
        block at the pad) and their velocities (None without
        prediction), from the whole fleet's states [N, 4] and commanded
        velocities [N, 3]."""
        L, dev = self.L, all_states.device
        ring, N = L.peers["ring"], all_states.shape[0]
        radii = torch.tensor(L.radius, device=dev).to(dtype)
        ang = np.linspace(0.0, 2.0 * np.pi, ring, endpoint=False)
        dirs = torch.tensor(np.stack([np.cos(ang), np.sin(ang)], axis=1),
                            dtype=torch.float32, device=dev).to(dtype)
        st = all_states.to(dtype)
        centers = st[:, None, 0:2]
        pts = torch.cat([centers, centers + radii[:, None, None] * dirs[None]], dim=1)
        pts = pts.reshape(-1, 2)
        block = ring + 1
        slot = torch.arange(N * block, device=dev) // block
        own = slot[None, :, None] == torch.tensor(self.rows, device=dev)[:, None, None]
        rows = torch.where(own, PAD, pts[None].expand(len(self.rows), -1, -1))
        vel = None
        if L.peers["predict"]:
            v = all_vels.to(dtype)
            cy, sy = torch.cos(st[:, 2]), torch.sin(st[:, 2])
            vw = torch.stack([v[:, 0] * cy - v[:, 1] * sy, v[:, 0] * sy + v[:, 1] * cy], 1)
            per = vw[:, None, :].expand(N, block, 2).reshape(-1, 2)
            vel = torch.where(own, 0.0, per[None].expand(len(self.rows), -1, -1))
        return rows, vel, (N - 1) * block

    # --- the solve ---

    def solve(self, plan, states, vels, obs, obs_vel, obs_count, dtype=torch.float32):
        """Every sample's masked cost [B, S] and what the tick returns."""
        L = self.L
        dev = states.device
        f = dtype
        pr = self.params12.to(f)
        dt = pr[:, 0]
        lim = self.limits9.to(f)
        cv = vels.to(f)

        def axis(v0, vmax, acc, dec, n):
            v0 = torch.minimum(torch.maximum(v0, -vmax), vmax)
            hi = torch.minimum(vmax, v0 + acc * dt)
            lo = torch.maximum(-vmax, v0 - dec * dt)
            res = torch.clamp(div_t(hi - lo, max(n - 1, 1)), min=0.001)
            vals = lo[:, None] + torch.arange(n, dtype=f, device=dev) * res[:, None]
            mask = vals <= (hi + 1e-5 * torch.abs(hi) + 1e-7)[:, None]
            return vals, mask

        vx_vals, vx_mask = axis(cv[:, 0], lim[:, 0], lim[:, 1], lim[:, 2], L.n_vx)
        w_vals, w_mask = axis(cv[:, 2], lim[:, 6], lim[:, 7], lim[:, 8], L.n_omega)
        B = states.shape[0]
        vx = vx_vals.unsqueeze(-1).expand(B, L.n_vx, L.n_omega).reshape(B, -1)
        w = w_vals.unsqueeze(-2).expand(B, L.n_vx, L.n_omega).reshape(B, -1)
        valid = (vx_mask.unsqueeze(-1).expand(B, L.n_vx, L.n_omega).reshape(B, -1)
                 & w_mask.unsqueeze(-2).expand(B, L.n_vx, L.n_omega).reshape(B, -1)
                 & (vx.abs() >= MIN_VEL))
        grid = torch.stack([vx, torch.zeros_like(vx), w], dim=-1)  # [B, S, 3]

        # rollout
        st = states.to(f)
        T = L.T
        dtc = dt[:, None, None]
        x0, y0, yaw0 = (st[:, i][:, None, None] for i in range(3))
        t = torch.arange(T - 1, dtype=f, device=dev)
        gvx, gw = grid[..., 0:1], grid[..., 2:3]
        gvy = grid[..., 1:2]
        yaw_t = yaw0 + gw * t * dtc
        c, s = torch.cos(yaw_t), torch.sin(yaw_t)
        ddx = (gvx * c - gvy * s) * dtc
        ddy = (gvx * s + gvy * c) * dtc
        zero = grid.new_zeros(B, L.S, 1)

        def prefix(d):
            return torch.cumsum(d.transpose(-1, -2).contiguous(), dim=-2).transpose(-1, -2)

        px = torch.cat([zero + x0, x0 + prefix(ddx)], dim=-1)
        py = torch.cat([zero + y0, y0 + prefix(ddy)], dim=-1)

        ap = plan["active"]
        tt = torch.arange(T, device=dev)
        active_mask = (tt[None, :] < ap[:, None])[:, None, :]
        obs = obs.to(f)
        seg_x, seg_y = plan["seg_x"].to(f), plan["seg_y"].to(f)
        tau = None if obs_vel is None else tt.to(f)[None, :] * dt[:, None]  # [B, T]
        ov = None if obs_vel is None else obs_vel.to(f)
        d2_obs = _sweep(px, py, obs[..., 0], obs[..., 1], ov, tau)
        d2_seg = _sweep(px, py, seg_x, seg_y, None, None)
        d2_obs = torch.where(active_mask, d2_obs, math.inf)
        d2_seg = torch.where(active_mask, d2_seg, math.inf)

        if L.has_box:
            tb = torch.arange(T, dtype=f, device=dev)
            yaw = yaw0 + gw * tb * dtc
            d2_col = _box_sweep(px, py, torch.cos(yaw), torch.sin(yaw), obs, ov, tau,
                                self.box2.to(f))
            d2_col = torch.where(active_mask, d2_col, math.inf)
            r = torch.clamp(pr[:, 2], min=1e-6)[:, None, None]
        else:
            d2_col = d2_obs
            r = (pr[:, 1] + pr[:, 2])[:, None, None]
        check = (tt >= 1) & (tt <= ap[:, None] - 1)  # [B, T]
        collide = (d2_col < r * r) & check.unsqueeze(-2)
        admissible = valid & ~collide.any(dim=-1)

        # costs (drop mode: every row keeps one velocity)
        total = px.new_zeros(B, L.S)
        ref_total = plan["ref_total"].to(f)
        has_path = ref_total > 0.0
        last_i = torch.clamp(plan["seg_count"] - 1, min=0).long()[:, None]
        seg_last_x = seg_x.gather(-1, last_i)[:, 0]
        seg_last_y = seg_y.gather(-1, last_i)[:, 0]
        idx = (ap - 1).clamp(0, T - 1).long()[:, None, None].expand(B, L.S, 1)
        end_x, end_y = px.gather(-1, idx)[..., 0], py.gather(-1, idx)[..., 0]
        gdx = end_x.unsqueeze(-1) - seg_x.unsqueeze(-2)
        gdy = end_y.unsqueeze(-1) - seg_y.unsqueeze(-2)
        gd2 = gdx * gdx + gdy * gdy
        j_star = torch.argmin(gd2, dim=-1)
        min_gd2 = torch.amin(gd2, dim=-1)
        arc_at = plan["seg_arc"].to(f).gather(-1, j_star)
        refc = ref_total[:, None]
        goal = (refc - arc_at) / refc + torch.sqrt(min_gd2) / refc
        total = total + torch.where((has_path & (pr[:, 4] > 0))[:, None], pr[:, 4][:, None] * goal, 0.0)
        pt_mask = tt[None, :] < ap[:, None]
        d = torch.sqrt(d2_seg)
        avg = torch.where(pt_mask.unsqueeze(-2), d, 0.0).sum(dim=-1) / ap.to(f)[:, None]
        ex = end_x - seg_last_x[:, None]
        ey = end_y - seg_last_y[:, None]
        seg_len = plan["seg_total"].to(f)[:, None]
        end_dist = torch.where(seg_len > 0.0,
                               torch.sqrt(ex * ex + ey * ey) / torch.clamp(seg_len, min=1e-9),
                               0.0)
        pathc = (avg + end_dist) / 2.0
        total = total + torch.where((has_path & (pr[:, 3] > 0))[:, None], pr[:, 3][:, None] * pathc, 0.0)
        do = torch.sqrt(torch.amin(d2_obs, dim=-1))
        reach = pr[:, 11][:, None]
        obst = torch.clamp(reach - do, min=0.0) / reach
        total = total + torch.where(((obs_count > 0) & (pr[:, 5] > 0))[:, None],
                                    pr[:, 5][:, None] * obst, 0.0)
        costs = torch.where(admissible, total, math.inf)
        best = torch.argmin(costs, dim=-1)
        found = admissible.any(dim=-1)
        first = grid.gather(1, best[:, None, None].expand(B, 1, 3))[:, 0]
        return dict(costs=costs, grid=grid, best=best, found=found,
                    cost=costs.gather(-1, best[:, None])[:, 0],
                    num_admissible=admissible.sum(dim=-1), first=first)

    def command(self, plan, sol):
        """The tick's command before the safety gate: rotate in place,
        and the zero command of a robot that found nothing or reached its
        goal."""
        he = plan["heading_error"]
        rotate = torch.abs(he) > self.ori_tol * 10.0  # every robot may rotate
        rot_omega = div_t(he * self.limits9[:, 6], math.pi)
        first = sol["first"].float()
        vx = torch.where(rotate, 0.0, first[:, 0])
        vy = torch.where(rotate, 0.0, first[:, 1])
        w = torch.where(rotate, rot_omega, first[:, 2])
        go = (rotate | sol["found"]) & ~plan["reached"]
        return dict(go=go, rotate=rotate, vx=torch.where(go, vx, 0.0),
                    vy=torch.where(go, vy, 0.0), w=torch.where(go, w, 0.0))

    @staticmethod
    def gate(cmd, safety_factor):
        """The command scaled by the safety factor; a factor of 0 stops
        the turn too."""
        out = dict(cmd)
        out["vx"] = cmd["vx"] * safety_factor
        out["vy"] = cmd["vy"] * safety_factor
        out["w"] = torch.where(safety_factor <= 0.0, 0.0, cmd["w"])
        out["sf"] = safety_factor
        return out

    def obstacles(self, scan_obs, scan_count, tracked, peers):
        """The sweep's rows of the sampled robots: the scan bucket
        [B, scan_size, 2] with the tracked movers [B, M, 4] (world x, y,
        vx, vy; pads at 1e8) in its tail, then the peer rows; their
        velocities where any row moves (None for a static world); the
        real rows' count."""
        obs = scan_obs
        count = torch.full((obs.shape[0],), scan_count, dtype=torch.int32,
                           device=obs.device)
        scan_len = obs.shape[1]
        m = 0
        if tracked is not None:
            m = tracked.shape[1]
            obs = torch.cat([obs[:, :scan_len - m], tracked[:, :, 0:2].to(obs.dtype)], 1)
            count = count + (tracked[:, :, 0] < 1e7).sum(-1).to(torch.int32)
        vel = None
        if peers is not None:
            rows, pvel, pcount = peers
            obs = torch.cat([obs, rows], 1)
            count = count + pcount
        moving = tracked is not None or (peers is not None and peers[1] is not None)
        if moving:
            parts = [obs.new_zeros(obs.shape[0], scan_len - m, 2)]
            if tracked is not None:
                parts.append(tracked[:, :, 2:4].to(obs.dtype))
            if peers is not None:
                parts.append(torch.zeros_like(peers[0]) if peers[1] is None else peers[1])
            vel = torch.cat(parts, 1)
        return obs, vel, count

    # --- the safety gate ---

    def _band(self, dist):
        z = self.zone
        denom = z["slow"] - z["crit"]
        return torch.clamp((dist - z["crit"][:, None]) / denom[:, None], 0.0, 1.0)

    def safety_scan(self, ranges, forward):
        if self.zone is None:
            return torch.ones(ranges.shape[0], device=ranges.device)
        z = self.zone
        x = ranges * z["cos_a"]
        y = ranges * z["sin_a"]
        c, s = z["sc"][:, None], z["ss"][:, None]
        zero = torch.zeros_like(ranges[:, 0:1])
        bx = (c * x - s * y) + zero
        by = (s * x + c * y) + zero
        dist = sqrt_rn(bx * bx + by * by) - z["rad"][:, None]
        factor = self._band(dist)
        mask = torch.where(forward[:, None], z["fwd"], z["bwd"])
        factor = torch.where(mask & torch.isfinite(ranges), factor, 1.0)
        return torch.amin(factor, dim=-1)

    def safety_world(self, obs_world, states, forward):
        if self.zone is None:
            return torch.ones(states.shape[0], device=states.device)
        z = self.zone
        x, y, yaw = states[:, 0], states[:, 1], states[:, 2]
        dx = obs_world[..., 0] - x[:, None]
        dy = obs_world[..., 1] - y[:, None]
        bearing = torch.abs(torch.remainder(
            torch.atan2(dy, dx) - yaw[:, None] + math.pi, 2.0 * math.pi) - math.pi)
        half = z["half"][:, None]
        in_cone = torch.where(forward[:, None], bearing <= half, bearing >= math.pi - half)
        factor = self._band(sqrt_rn(dx * dx + dy * dy) - z["rad"][:, None])
        return torch.amin(torch.where(in_cone, factor, 1.0), dim=-1)


def _slabs(B, S, T, O):
    """(robots, samples) per slab of a [B, S, T, O] sweep."""
    per = max(1, SLAB_ELEMS // (T * O))
    if per >= S:
        return max(1, per // S), S
    return 1, per


def _sweep(px, py, xs, ys, vel, tau):
    """[B, S, T] points against [B, O] rows: min over the rows of the
    direct squared distance, the rows at o + v * tau[B, T] when moving."""
    B, S, T = px.shape
    O = xs.shape[1]
    if vel is None:
        ox, oy = xs[:, None, None, :], ys[:, None, None, :]
    else:
        step = tau[:, :, None]
        ox = (xs[:, None, :] + vel[..., 0][:, None, :] * step)[:, None]
        oy = (ys[:, None, :] + vel[..., 1][:, None, :] * step)[:, None]
    nb, ns = _slabs(B, S, T, O)
    out = px.new_empty(px.shape)
    for b0 in range(0, B, nb):
        b = slice(b0, b0 + nb)
        for s0 in range(0, S, ns):
            s = slice(s0, s0 + ns)
            dx = px[b, s, :, None] - ox[b]
            dy = py[b, s, :, None] - oy[b]
            out[b, s] = torch.amin(dx * dx + dy * dy, dim=-1)
    return out


def _box_sweep(px, py, cos_yaw, sin_yaw, rows, vel, tau, half):
    """[B, S, T] squared distance from the oriented box (half extents
    [B, 2]) to the nearest row, 0 inside the footprint."""
    B, S, T = px.shape
    O = rows.shape[1]
    ox = rows[:, None, None, :, 0]
    oy = rows[:, None, None, :, 1]
    if vel is not None:
        tq = tau[:, None, :, None]
        ox = ox + vel[:, None, None, :, 0] * tq
        oy = oy + vel[:, None, None, :, 1] * tq
    hl = half[:, 0].reshape(B, 1, 1, 1)
    hw = half[:, 1].reshape(B, 1, 1, 1)
    c = cos_yaw.unsqueeze(-1)
    s = sin_yaw.unsqueeze(-1)
    nb, ns = _slabs(B, S, T, O)
    out = px.new_empty(px.shape)
    for b0 in range(0, B, nb):
        b = slice(b0, b0 + nb)
        for s0 in range(0, S, ns):
            sl = slice(s0, s0 + ns)
            dxw = ox[b] - px[b, sl, :, None]
            dyw = oy[b] - py[b, sl, :, None]
            cs, ss = c[b, sl], s[b, sl]
            bx = cs * dxw + ss * dyw
            by = -ss * dxw + cs * dyw
            ex = torch.clamp(torch.abs(bx) - hl[b], min=0.0)
            ey = torch.clamp(torch.abs(by) - hw[b], min=0.0)
            out[b, sl] = torch.amin(ex * ex + ey * ey, dim=-1)
    return out
