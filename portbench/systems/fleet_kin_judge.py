"""The output check of a fleet of mixed drives: the program's answers
judged by the plain reference ``portbench/reference/fleet_kin.py``.

As ``fleet_judge`` (its numbers, limits, sampled calls and the k-tick
integration of the program's own commands are the same), with what the
drives change: a command matches an admissible sample on all three of
vx, vy and omega, and a robot rotates in place only where its drive
may (an Ackermann robot never does), so an Ackermann robot turned in
place, or an altered vy command, is unmatched.
"""

import math

import numpy as np
import torch

from ..reference.fleet_kin import KinLayout, KinReference
from .fleet_judge import (
    TOL, Tally, _control_answers, _gated, _program, _solve, integrate, solve_calls,
)


def judge_rows(sol, cmd, plan, prog):
    """Per row (the gap in cost units, whether the answers match) of the
    answers ``prog`` against the reference's solve and command, as
    ``fleet_judge.judge_rows`` with a sample's vy in its match."""
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
    same_cmd = (close(prog["vx"], cmd["vx"]) & close(prog["vy"], cmd["vy"])
                & close(prog["w"], cmd["w"]))
    grid = sol["grid"].float()
    cand_w = torch.where(sf[:, None] <= 0.0, 0.0, grid[..., 2])
    match = (torch.isfinite(costs) & close(prog["vx"][:, None], grid[..., 0] * sf[:, None])
             & close(prog["vy"][:, None], grid[..., 1] * sf[:, None])
             & close(prog["w"][:, None], cand_w))
    g = torch.maximum(costs - cmin[:, None], torch.abs(cost_p[:, None] - costs))
    g = torch.where(match, g, math.inf).amin(-1)
    simple = ~cmd["go"] | cmd["rotate"]
    matched = flags & torch.where(simple, same_cmd, torch.isfinite(g))
    gap = torch.where(simple | ~torch.isfinite(g), cost_err, g)
    wrong = ~torch.isfinite(gap)
    return torch.where(wrong, math.inf, gap), matched & ~wrong


def check(cfg, rec, paths, angles, device, first_window_call, count, seed,
          control=False):
    """Judge the record; returns the program's numbers (and, with
    ``control``, the control's: the reference's solve and k-tick
    integration in bfloat16)."""
    device = torch.device(device)
    layout = KinLayout(cfg, rec.n)
    ref = KinReference(layout, rec.rows, angles, paths, device)
    due = solve_calls(first_window_call, len(rec.calls), count, seed)
    rows_t = torch.tensor(rec.rows, device=device)
    dt_all = torch.full((rec.n,), np.float32(layout.dt), device=device)
    prog, ctrl = Tally(), Tally()

    def safety(fwd):
        return torch.ones(fwd.shape[0], device=device)

    with torch.no_grad():
        for j, c in enumerate(rec.calls):
            s_all = torch.tensor(c["states"], device=device)
            ranges = torch.tensor(c["ranges"], device=device)
            k = rec.k
            pose0 = s_all[rows_t]
            s_t, v_t = s_all, torch.tensor(c["vels"], device=device)
            s_lo = s_all.to(torch.bfloat16)
            for t in range(k):
                st = s_t[rows_t]
                plan = ref.follow(st)
                if j in due:
                    pose, count_scan = ((st, min(layout.rays, layout.scan_size)) if k == 1
                                        else (pose0, layout.scan_size))
                    vels = v_t[rows_t]
                    sol = _solve(ref, plan, st, vels, ranges, pose, count_scan, None, None,
                                 torch.float32)
                    cmd = _gated(ref, plan, sol, safety)
                    prog.add(judge_rows(sol, cmd, plan,
                                        _program(c, None if k == 1 else t, device)))
                    if control:
                        sol_lo = _solve(ref, plan, st, vels, ranges, pose, count_scan, None,
                                        None, torch.bfloat16)
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
