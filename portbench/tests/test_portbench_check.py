"""The output check: the port agrees with the plain reference at a small
size on the CPU; the lower-precision control and each fault of the timed
path come out as not correct."""

import json
import math

import numpy as np
import pytest
import torch

from portbench.control import readings
from portbench.harness import main as M
from portbench.systems import fleet as fleet_mod
from portbench.systems import fleet_judge
from portbench.tests.tiny import VARIANTS, tiny_cell

SEED = 2**31 + 977
K_TICK = [v for v in VARIANTS if v[1] > 1]


def passes(numbers, limits):
    return all(numbers[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("variant", VARIANTS)
def test_port_agrees_with_the_reference(variant):
    cfg, traffic, limits = tiny_cell(*variant)
    s = M.Session(cfg, traffic, SEED, torch.device("cpu"))
    s.warm()
    s.measure(0.3)
    s.release()
    numbers = s.check()
    assert numbers["judged_rows"] > 0
    assert numbers["cost_gap"] == 0.0 and numbers["unmatched"] == 0
    assert numbers.get("state_err_m", 0.0) == 0.0
    assert passes(numbers, limits)


@pytest.mark.parametrize("name", ("disc1024.tick", "boxpeer64.k8"))
def test_the_control_fails_the_check(name):
    cfg, traffic, limits = tiny_cell(name)
    for seed, prog, ctrl in readings(name, [SEED, SEED + 1, SEED + 2], 0.3,
                                     torch.device("cpu"), cfg, traffic):
        assert passes(prog, limits)
        assert not passes(ctrl, limits), (seed, ctrl)


class A:
    seconds = 0.3
    trace = 0


def run_with(variant, fault, capsys, monkeypatch):
    """One whole run of the cell at the small size on the CPU (the look
    for a card skipped), with ``fault`` breaking the timed path."""
    name = variant[0]
    cfg, traffic, limits = tiny_cell(*variant)
    entry = fleet_mod.entry

    def broken(fleet, k):
        call = entry(fleet, k)
        return lambda *a, **kw: fault(call(*a, **kw), a)

    monkeypatch.setattr(fleet_mod, "entry", broken)
    bench, cell, *_ = M.load_cell(name)
    args = A()
    args.seed = SEED
    args.workload = name
    assert M.run(args, bench, cell, cfg, traffic, limits, torch.device("cpu"), 0.0) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def altered(out, args):
    out = dict(out)
    out["vx"] = out["vx"] + np.float32(0.05)
    return out


def half_left_out(out, args):
    out = {k: np.array(v, copy=True) for k, v in out.items()}
    n = len(out["vx"]) // 2
    for f in ("vx", "vy", "omega", "cost"):
        out[f][n:] = 0.0
    out["found"][n:] = False
    return out


def state_unchanged(out, args):
    out = dict(out)
    out["final_states"] = np.asarray(args[0], np.float32).copy()
    return out


def identity(out, args):
    return out


@pytest.mark.parametrize("variant", VARIANTS)
def test_sound_run_is_correct(variant, capsys, monkeypatch):
    assert run_with(variant, identity, capsys, monkeypatch)["correct"] is True


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("fault", [altered, half_left_out])
def test_faults_are_not_correct(variant, fault, capsys, monkeypatch):
    assert run_with(variant, fault, capsys, monkeypatch)["correct"] is False


@pytest.mark.parametrize("variant", K_TICK)
def test_unchanged_state_is_not_correct(variant, capsys, monkeypatch):
    result = run_with(variant, state_unchanged, capsys, monkeypatch)
    assert result["correct"] is False
    assert result["checks"]["state_err_m"]["value"] > result["checks"]["state_err_m"]["limit"]


def test_a_cost_finite_on_one_side_only_is_not_correct():
    """A stopped row whose reported cost is finite where the reference
    finds no admissible sample reads an infinite gap and is unmatched."""
    zeros = torch.zeros(2)
    stopped = torch.tensor([False, False])
    sol = dict(costs=torch.tensor([[math.inf] * 3, [1.0, 2.0, 3.0]]),
               num_admissible=torch.tensor([0, 3]), grid=torch.zeros(2, 3, 3))
    cmd = dict(go=stopped, rotate=stopped, vx=zeros, vy=zeros, w=zeros, sf=torch.ones(2))
    plan = dict(reached=stopped, active=torch.tensor([30, 30], dtype=torch.int32))
    prog = dict(go=stopped, reached=stopped, vx=zeros, vy=zeros, w=zeros,
                cost=torch.tensor([1.0, 1.0]), active=plan["active"],
                admissible=torch.tensor([0, 3]), sf=torch.ones(2))
    tally = fleet_judge.Tally()
    tally.add(fleet_judge.judge_rows(sol, cmd, plan, prog))
    numbers = tally.numbers(1)
    assert numbers["cost_gap"] == math.inf and numbers["unmatched"] == 1
    assert not passes(numbers, {"cost_gap": 0.001, "unmatched": 0})
    assert M.plain(numbers["cost_gap"]) == "inf"


@pytest.mark.parametrize("seed", range(2**31, 2**31 + 300, 7))
def test_every_sample_judges_a_box_and_the_boxed_in_robot(seed):
    _, _, cfg, traffic, _ = M.load_cell("boxpeer64.k8")
    scene = M.make_scene(traffic, cfg, seed)
    is_box = fleet_mod.Layout(cfg, scene.n).is_box
    rows = fleet_mod.sample_rows(scene.n, traffic["check_robots"], seed,
                                 strata=(np.flatnonzero(is_box), np.flatnonzero(~is_box)),
                                 always=scene.check_always)
    assert len(set(rows.tolist())) == traffic["check_robots"]
    assert scene.n - 1 in rows and is_box[rows].any() and (~is_box[rows]).any()
