"""Every cell of BENCHMARK.json resolves to its files by name."""

import importlib
import json
import sys
import types
from pathlib import Path

import pytest
import torch

from portbench.harness.main import BENCH, ROOT, Session, cell_metrics, load_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    bench, cell, cfg, traffic, limits = load_cell(name)
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    assert cfg["name"] == cell["config"]
    assert cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert Path(ROOT / entry["file"]).resolve().is_relative_to(BENCH)
    assert (BENCH / "scenes" / f"{traffic['scene']}.py").is_file()
    assert (BENCH / "systems" / f"{cfg['system']}.py").is_file()
    assert set(limits) >= {"cost_gap", "unmatched"}
    assert ("state_err_m" in limits) == (traffic.get("k", 1) > 1)


@pytest.mark.parametrize("name", CELLS)
def test_every_metric_of_a_cell_has_a_reader(name):
    for m in cell_metrics(SPEC, name, True):
        assert callable(importlib.import_module(f"portbench.metrics.{m['name']}").read)
    e2e = {m["name"] for m in cell_metrics(SPEC, name, False)}
    assert {"solves_per_s", "call_p95_ms", "setup_s"} <= e2e


def test_every_configuration_is_used_and_every_moved_metric_exists():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])


def test_a_new_scene_and_system_are_found_by_name(monkeypatch):
    """A configuration's ``system`` and a traffic's ``scene`` resolve to
    modules of those names: a new kind is a new file, no edit."""
    scene_mod, system_mod = types.ModuleType("s"), types.ModuleType("y")

    class Scene:
        def __init__(self, traffic, cfg, seed):
            self.seed = seed

    class System:
        def __init__(self, cfg, traffic, scene, seed, device):
            self.scene = scene

    scene_mod.Scene, system_mod.System = Scene, System
    monkeypatch.setitem(sys.modules, "portbench.scenes.some_new_scene", scene_mod)
    monkeypatch.setitem(sys.modules, "portbench.systems.some_new_system", system_mod)
    s = Session({"system": "some_new_system"}, {"scene": "some_new_scene"}, 5,
                torch.device("cpu"))
    assert isinstance(s.scene, Scene) and s.system.scene is s.scene and s.scene.seed == 5


def test_a_metric_listing_its_cells_is_reported_in_those_alone():
    """A metric with a ``workloads`` key (the contract's, for a metric a
    later cell alone reports) is asked of its cells and no others."""
    bench = {"per_layer": [{"name": "a"}, {"name": "b", "workloads": ["x.k8"]}],
             "end_to_end": [{"name": "c", "workloads": ["y.tick"]}]}
    assert [m["name"] for m in cell_metrics(bench, "x.k8", True)] == ["a", "b"]
    assert [m["name"] for m in cell_metrics(bench, "y.tick", True)] == ["a"]
    assert [m["name"] for m in cell_metrics(bench, "x.k8", False)] == []
