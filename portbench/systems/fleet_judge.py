"""The fleet's output check: the program's answers judged by the plain
reference.

After the window the reference (``portbench/reference/fleet.py``) runs
the sampled robots' follower through every recorded call and, at a
seeded sample of the window's calls and the last, recomputes each
sampled robot's whole tick from the recorded inputs: the costs of every
sample, the command, the flags. In a k-tick call it
integrates the whole fleet's states from the program's own per-tick
commands, so every tick of the call is judged at the state the program
was at, and compares the call's final states with its integration.

Numbers (each cell's limits are ``portbench/limits/<cell>.json``):

- ``cost_gap``: over the judged rows, the largest amount by which the
  reference's cost of the program's command lies above the reference's
  best, or by which the program's reported cost differs from the
  reference's cost of that command (of the reference's best where the
  command is no admissible sample); cost units, absolute; infinite where
  a row's cost is finite on one side and not on the other.
- ``unmatched``: rows whose go, reached, active-points, admissible-count
  or safety-factor output differs from the reference's, whose command
  is no admissible sample of the reference's window (or, rotating in
  place or stopped, not the reference's command), or whose cost is
  finite on one side only.
- ``state_err_m`` (k-tick calls): the largest difference between the
  call's final states and the reference's integration of its commands.

``control=True`` also judges the lower-precision control in the
program's place: the reference's solve in bfloat16, emitting the sample
it ranks first.
"""

import math

import numpy as np
import torch

from ..reference.fleet import FleetReference, Layout, sqrt_rn

TOL = 1e-6


def solve_calls(first: int, total: int, count: int, seed: int):
    """The window's calls whose answers are recomputed: a seeded sample
    and the last."""
    rng = np.random.default_rng([int(seed), 2])
    window = np.arange(first, total)
    pick = rng.choice(window, min(count, len(window)), replace=False) if len(window) else []
    return set(int(j) for j in pick) | ({total - 1} if total > first else set())


def prepare_tracked(raw, device):
    """The raw tracked rows [B, M, 4] as the fleet reads them: a row with
    any non-finite value is an empty slot, at the 1e8 pad, not moving."""
    arr = torch.tensor(raw, device=device)
    ok = torch.isfinite(arr).all(-1, keepdim=True)
    pad = torch.tensor([1e8, 1e8, 0.0, 0.0], device=device)
    return torch.where(ok, arr, pad)


def integrate(s, cmd, dt):
    vx, vy, om = cmd[:, 0], cmd[:, 1], cmd[:, 2]
    cy, sy = torch.cos(s[:, 2]), torch.sin(s[:, 2])
    return torch.stack([
        s[:, 0] + dt * (vx * cy - vy * sy),
        s[:, 1] + dt * (vx * sy + vy * cy),
        s[:, 2] + dt * om,
        sqrt_rn(vx * vx + vy * vy),
    ], dim=-1)


def judge_rows(sol, cmd, plan, prog):
    """Per row (the gap in cost units, whether the answers match) of the
    answers ``prog`` (go, reached, vx, vy, w, cost, active, admissible,
    sf: [B] tensors) against the reference's solve and gated command.
    The gap of a row whose command is an admissible sample is that
    sample's excess over the best and its reported cost's error; of any
    other row, its reported cost's distance from the reference's. A row
    whose cost is finite on one side and not on the other is a wrong
    answer: its gap is infinite and it does not match."""
    def close(a, b):
        return torch.abs(a - b) <= TOL + TOL * torch.abs(b)

    sf = cmd["sf"]
    flags = ((prog["go"] == cmd["go"]) & (prog["reached"] == plan["reached"])
             & (prog["active"] == plan["active"])
             & (prog["admissible"] == sol["num_admissible"])
             & close(prog["sf"], sf))
    costs = sol["costs"].double()
    cmin = costs.amin(-1)
    cost_p = prog["cost"].double()
    expected = torch.where(cmd["rotate"], 0.0, cmin)
    both_inf = torch.isinf(cost_p) & torch.isinf(expected) & (cost_p == expected)
    cost_err = torch.where(both_inf, 0.0, torch.abs(cost_p - expected))
    same_cmd = close(prog["vx"], cmd["vx"]) & close(prog["vy"], cmd["vy"]) & close(prog["w"], cmd["w"])
    grid = sol["grid"].float()
    cand_vx = grid[..., 0] * sf[:, None]
    cand_w = torch.where(sf[:, None] <= 0.0, 0.0, grid[..., 2])
    match = (torch.isfinite(costs) & close(prog["vx"][:, None], cand_vx)
             & close(prog["w"][:, None], cand_w) & close(prog["vy"], torch.zeros_like(sf))[:, None])
    g = torch.maximum(costs - cmin[:, None], torch.abs(cost_p[:, None] - costs))
    g = torch.where(match, g, math.inf).amin(-1)
    simple = ~cmd["go"] | cmd["rotate"]
    matched = flags & torch.where(simple, same_cmd, torch.isfinite(g))
    gap = torch.where(simple | ~torch.isfinite(g), cost_err, g)
    wrong = ~torch.isfinite(gap)
    return torch.where(wrong, math.inf, gap), matched & ~wrong


class Tally:
    def __init__(self):
        self.gaps = []
        self.matched = []
        self.state_err = 0.0
        self.rows = 0

    def add(self, judged):
        gap, matched = judged
        self.gaps.append(gap.cpu().numpy())
        self.matched.append(matched.cpu().numpy())
        self.rows += len(self.gaps[-1])

    def numbers(self, k: int) -> dict:
        g = np.concatenate(self.gaps) if self.gaps else np.zeros(0)
        m = np.concatenate(self.matched) if self.matched else np.zeros(0, bool)
        out = {"cost_gap": float(g.max()) if len(g) else 0.0,
               "unmatched": int((~m).sum())}
        if k > 1:
            out["state_err_m"] = float(self.state_err)
        out["judged_rows"] = int(self.rows)
        return out


def _program(c, t, device):
    """The recorded answers of call ``c`` (tick ``t`` of a k-tick call)."""
    o = c["out"]

    def f(name, dtype=torch.float32):
        v = o[name] if t is None else o[name][:, t]
        return torch.tensor(np.asarray(v), device=device).to(dtype)

    return dict(go=f("found", torch.bool), reached=f("reached", torch.bool),
                vx=f("vx"), vy=f("vy"), w=f("omega"), cost=f("cost"),
                active=f("active_points", torch.int32),
                admissible=f("num_admissible", torch.int64),
                sf=f("safety_factor"))


def _solve(ref, plan, st, vels, ranges, pose, count_scan, trk, peers_of, dtype):
    """The reference's solve of one tick of the sampled robots; the scan
    converted to world points at ``pose`` in ``dtype``."""
    scan_obs = ref.scan_world(ranges, pose, dtype)
    peers = None if peers_of is None else peers_of(dtype)
    obs, vel, count = ref.obstacles(scan_obs, count_scan, trk, peers)
    return ref.solve(plan, st, vels, obs, vel, count, dtype=dtype)


def _gated(ref, plan, sol, safety):
    cmd = ref.command(plan, sol)
    return ref.gate(cmd, safety(cmd["vx"] >= 0.0))


def _control_answers(ref, plan, sol32, sol_lo, safety):
    """The control's answers: the sample the bfloat16 solve ranks first,
    emitted as the configuration's command, its cost as computed."""
    first = sol32["grid"].gather(1, sol_lo["best"][:, None, None].expand(-1, 1, 3))[:, 0]
    ctrl = dict(first=first, found=sol_lo["found"])
    cmd = _gated(ref, plan, ctrl, safety)
    return dict(go=cmd["go"], reached=plan["reached"], vx=cmd["vx"], vy=cmd["vy"],
                w=cmd["w"], cost=torch.where(cmd["rotate"], 0.0, sol_lo["cost"].float()),
                active=plan["active"], admissible=sol_lo["num_admissible"], sf=cmd["sf"])


def check(cfg, rec, paths, angles, device, first_window_call, count, seed,
          control=False):
    """Judge the record; returns the program's numbers (and, with
    ``control``, the control's)."""
    device = torch.device(device)
    layout = Layout(cfg, rec.n)
    ref = FleetReference(layout, rec.rows, angles, paths, device)
    due = solve_calls(first_window_call, len(rec.calls), count, seed)
    rows_t = torch.tensor(rec.rows, device=device)
    dt_all = torch.full((rec.n,), np.float32(layout.dt), device=device)
    prog, ctrl = Tally(), Tally()
    with torch.no_grad():
        for j, c in enumerate(rec.calls):
            s_all = torch.tensor(c["states"], device=device)
            v_all = torch.tensor(c["vels"], device=device)
            ranges = torch.tensor(c["ranges"], device=device)
            trk0 = None if c["tracked"] is None else prepare_tracked(c["tracked"], device)
            k = rec.k
            pose0 = s_all[rows_t]
            scan_obs = ref.scan_world(ranges, pose0) if k > 1 else None
            s_t, v_t = s_all, v_all
            s_lo = s_all.to(torch.bfloat16)
            for t in range(k):
                st = s_t[rows_t]
                plan = ref.follow(st)
                if j in due:
                    if k == 1:
                        trk, pose = trk0, st
                        count_scan = min(layout.rays, layout.scan_size)

                        def safety(fwd):
                            return ref.safety_scan(ranges, fwd)
                    else:
                        trk = None
                        if trk0 is not None:
                            shift = trk0[:, :, 2:4] * (float(t) * dt_all[rows_t])[:, None, None]
                            pos = torch.where(trk0[:, :, 0:1] < 1e7, trk0[:, :, 0:2] + shift,
                                              trk0[:, :, 0:2])
                            trk = torch.cat([pos, trk0[:, :, 2:4]], dim=-1)
                        count_scan, pose = layout.scan_size, pose0

                        def safety(fwd, st=st):
                            return ref.safety_world(scan_obs, st, fwd)
                    peers_of = None
                    if layout.peers:
                        def peers_of(dtype, s=s_t, v=v_t):
                            return ref.peer_rows(s, v, dtype)
                    vels = v_t[rows_t]
                    sol = _solve(ref, plan, st, vels, ranges, pose, count_scan, trk,
                                 peers_of, torch.float32)
                    cmd = _gated(ref, plan, sol, safety)
                    answers = _program(c, None if k == 1 else t, device)
                    prog.add(judge_rows(sol, cmd, plan, answers))
                    if control:
                        sol_lo = _solve(ref, plan, st, vels, ranges, pose, count_scan, trk,
                                        peers_of, torch.bfloat16)
                        ans = _control_answers(ref, plan, sol, sol_lo, safety)
                        ctrl.add(judge_rows(sol, cmd, plan, ans))
                if k > 1:
                    cm = torch.tensor(c["cmds"][:, t], device=device)
                    s_t = integrate(s_t, cm, dt_all)
                    v_t = cm
                    if control:
                        s_lo = integrate(s_lo, cm.to(torch.bfloat16), dt_all.to(torch.bfloat16))
            if k > 1:
                final = torch.tensor(c["final"], device=device)
                prog.state_err = max(prog.state_err, float(
                    torch.abs(final - s_t[rows_t]).max()))
                if control:
                    ctrl.state_err = max(ctrl.state_err, float(
                        torch.abs(s_lo[rows_t].float() - s_t[rows_t]).max()))
    out = prog.numbers(rec.k)
    if control:
        return out, ctrl.numbers(rec.k)
    return out
