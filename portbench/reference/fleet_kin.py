"""Plain PyTorch reference of one tick of a fleet of mixed drives (omni,
Ackermann, differential), for the output check of the ``fleet_kin``
system.

It builds on ``reference/fleet.py`` (the follower, the scan, the sweeps
and the safety gate are that file's) and adds what the drives change:

- per robot its drive, radius and limits: robot i takes the
  configuration's ``robot.kinds[i % len(kinds)]``;
- the omni-shaped grid wherever any robot is omni: the linear samples
  split 75/25 between vx and vy, each count bumped odd, and per vx value
  first the (vx, vy, 0) block of the vy values, then the (vx, 0, omega)
  block of the omega values;
- the validity of a sample: its values inside their windows; an omega
  sample needs |vx| >= 0.01, a vy sample |vx| or |vy| >= 0.01;
- zeroed vy limits for every robot that is not omni, so only its first
  vy value (0) is inside its window;
- the rollout's and the command's vy terms;
- rotation in place for every robot but an Ackermann one.

It handles what the ``fleet_kin`` configurations use: cylinders, drop
mode, a static scan, no peers, tracked movers or safety gate.
"""

import math

import numpy as np
import torch

from .fleet import MIN_VEL, FleetReference, Layout, _sweep, div_t


def odd(n: int) -> int:
    return n + 1 if n % 2 == 0 else n


def kinds_of(cfg: dict, n: int) -> list:
    """The kind of each of ``n`` robots."""
    kinds = cfg["robot"]["kinds"]
    return [kinds[i % len(kinds)] for i in range(n)]


def limits_row(kind: dict) -> list:
    """(max, acc, decel) of vx, vy and omega; vy zero for a robot that is
    not omni (its vy limits are discarded)."""
    lim = kind["limits"]
    vy = lim.get("vy", [0.0, 0.0, 0.0]) if kind["drive"] == "OMNI" else [0.0, 0.0, 0.0]
    return [*lim["vx"], *vy, *lim["omega"]]


class KinLayout(Layout):
    """``Layout`` of a fleet of mixed drives: the fleet-wide sizes of the
    base (the path window sized by the fleet's fastest robot) and the
    grid's and the robots' own rows."""

    def __init__(self, cfg: dict, n_robots: int):
        kinds = cfg["robot"]["kinds"]
        if any(k["geometry"] != "CYLINDER" for k in kinds):
            raise ValueError("the reference handles cylinder robots")
        if cfg.get("peers") or cfg.get("safety") or cfg["tracked_obstacles"]:
            raise ValueError("the reference handles a static scan alone")
        vx_max = max(k["limits"]["vx"][0] for k in kinds)
        super().__init__(dict(cfg, robot=dict(drive="DIFFERENTIAL_DRIVE",
                                              circle_params=kinds[0]["params"]),
                              limits=dict(vx=[vx_max, 0.0, 0.0], omega=[0.0, 0.0, 0.0])),
                         n_robots)
        per = kinds_of(cfg, n_robots)
        self.drive = np.array([k["drive"] for k in per])
        self.omni_grid = bool((self.drive == "OMNI").any())
        if self.omni_grid:
            lin = int(cfg["dwa"]["max_linear_samples"])
            self.n_vx = odd(max(3, lin * 3 // 4))
            self.n_vy = odd(max(3, lin // 4))
            self.S = self.n_vx * (self.n_vy + self.n_omega)
        self.limits9 = np.array([limits_row(k) for k in per], np.float32)
        self.radius = np.array([k["params"][0] for k in per], np.float32)
        self.geometry = [("CYLINDER", np.asarray(k["params"], np.float64)) for k in per]
        self.vx_max = self.limits9[:, 0].copy()
        self.params12[:, 1] = self.radius
        self.params12[:, 8:11] = self.limits9[:, [1, 4, 7]]


class KinReference(FleetReference):
    """The reference fleet of a ``KinLayout`` for the robots ``rows``."""

    def __init__(self, layout: KinLayout, rows, angles, paths, device):
        super().__init__(layout, rows, angles, paths, device)
        self.rotate_ok = torch.tensor(layout.drive[self.rows] != "ACKERMANN",
                                      device=self.device)

    def grid(self, vels, dtype):
        """Every sample's (vx, vy, omega) [B, S, 3] and validity [B, S]."""
        L = self.L
        f = dtype
        dt = self.params12.to(f)[:, 0]
        lim = self.limits9.to(f)
        cv = vels.to(f)
        dev = vels.device

        def axis(v0, vmax, acc, dec, n):
            v0 = torch.minimum(torch.maximum(v0, -vmax), vmax)
            hi = torch.minimum(vmax, v0 + acc * dt)
            lo = torch.maximum(-vmax, v0 - dec * dt)
            res = torch.clamp(div_t(hi - lo, max(n - 1, 1)), min=0.001)
            vals = lo[:, None] + torch.arange(n, dtype=f, device=dev) * res[:, None]
            mask = vals <= (hi + 1e-5 * torch.abs(hi) + 1e-7)[:, None]
            return vals, mask

        vx, vx_ok = axis(cv[:, 0], lim[:, 0], lim[:, 1], lim[:, 2], L.n_vx)
        vy, vy_ok = axis(cv[:, 1], lim[:, 3], lim[:, 4], lim[:, 5], L.n_vy)
        w, w_ok = axis(cv[:, 2], lim[:, 6], lim[:, 7], lim[:, 8], L.n_omega)
        B = vels.shape[0]
        blocks, valid = [], []
        for i in range(L.n_vx):
            v = vx[:, i:i + 1]
            moves = v.abs() >= MIN_VEL
            if L.omni_grid:
                blocks.append(torch.stack([v.expand(B, L.n_vy), vy,
                                           torch.zeros_like(vy)], -1))
                valid.append(vx_ok[:, i:i + 1] & vy_ok & (moves | (vy.abs() >= MIN_VEL)))
            blocks.append(torch.stack([v.expand(B, L.n_omega), torch.zeros_like(w), w], -1))
            valid.append(vx_ok[:, i:i + 1] & w_ok & moves)
        return torch.cat(blocks, 1), torch.cat(valid, 1)

    def solve(self, plan, states, vels, obs, obs_vel, obs_count, dtype=torch.float32):
        """Every sample's masked cost [B, S] and what the tick returns."""
        L = self.L
        dev = states.device
        f = dtype
        pr = self.params12.to(f)
        dt = pr[:, 0]
        grid, valid = self.grid(vels, f)
        B = states.shape[0]

        # rollout: the heading before each step, the body velocity rotated
        # into the world and summed step by step
        st = states.to(f)
        T = L.T
        dtc = dt[:, None, None]
        x0, y0, yaw0 = (st[:, i][:, None, None] for i in range(3))
        t = torch.arange(T - 1, dtype=f, device=dev)
        gvx, gvy, gw = grid[..., 0:1], grid[..., 1:2], grid[..., 2:3]
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
        d2_obs = torch.where(active_mask, _sweep(px, py, obs[..., 0], obs[..., 1], None, None),
                             math.inf)
        d2_seg = torch.where(active_mask, _sweep(px, py, seg_x, seg_y, None, None), math.inf)
        r = (pr[:, 1] + pr[:, 2])[:, None, None]
        check = (tt >= 1) & (tt <= ap[:, None] - 1)  # [B, T]
        collide = (d2_obs < r * r) & check.unsqueeze(-2)
        admissible = valid & ~collide.any(dim=-1)

        # costs (drop mode: every row keeps one velocity)
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
        arc_at = plan["seg_arc"].to(f).gather(-1, torch.argmin(gd2, dim=-1))
        refc = ref_total[:, None]
        goal = (refc - arc_at) / refc + torch.sqrt(torch.amin(gd2, dim=-1)) / refc
        total = torch.where((has_path & (pr[:, 4] > 0))[:, None], pr[:, 4][:, None] * goal, 0.0)
        pt_mask = tt[None, :] < ap[:, None]
        avg = torch.where(pt_mask.unsqueeze(-2), torch.sqrt(d2_seg), 0.0).sum(dim=-1) / ap.to(
            f)[:, None]
        ex = end_x - seg_last_x[:, None]
        ey = end_y - seg_last_y[:, None]
        seg_len = plan["seg_total"].to(f)[:, None]
        end_dist = torch.where(seg_len > 0.0,
                               torch.sqrt(ex * ex + ey * ey) / torch.clamp(seg_len, min=1e-9),
                               0.0)
        pathc = (avg + end_dist) / 2.0
        total = total + torch.where((has_path & (pr[:, 3] > 0))[:, None],
                                    pr[:, 3][:, None] * pathc, 0.0)
        reach = pr[:, 11][:, None]
        obst = torch.clamp(reach - torch.sqrt(torch.amin(d2_obs, dim=-1)), min=0.0) / reach
        total = total + torch.where(((obs_count > 0) & (pr[:, 5] > 0))[:, None],
                                    pr[:, 5][:, None] * obst, 0.0)
        costs = torch.where(admissible, total, math.inf)
        best = torch.argmin(costs, dim=-1)
        return dict(costs=costs, grid=grid, best=best, found=admissible.any(dim=-1),
                    cost=costs.gather(-1, best[:, None])[:, 0],
                    num_admissible=admissible.sum(dim=-1),
                    first=grid.gather(1, best[:, None, None].expand(B, 1, 3))[:, 0])

    def command(self, plan, sol):
        """The tick's command before the safety gate: rotate in place (not
        an Ackermann robot), and the zero command of a robot that found
        nothing or reached its goal."""
        he = plan["heading_error"]
        rotate = self.rotate_ok & (torch.abs(he) > self.ori_tol * 10.0)
        rot_omega = div_t(he * self.limits9[:, 6], math.pi)
        first = sol["first"].float()
        vx = torch.where(rotate, 0.0, first[:, 0])
        vy = torch.where(rotate, 0.0, first[:, 1])
        w = torch.where(rotate, rot_omega, first[:, 2])
        go = (rotate | sol["found"]) & ~plan["reached"]
        return dict(go=go, rotate=rotate, vx=torch.where(go, vx, 0.0),
                    vy=torch.where(go, vy, 0.0), w=torch.where(go, w, 0.0))

