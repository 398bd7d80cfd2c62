"""The port's planning front end end to end against the JAX package, and
the lifetime of its captured graphs.

BIT*, ABIT* and AIT* draw their batches on the host from NumPy's
generator seeded with the round's seed, in both packages, and search
each batch with the dense roadmap solve: with one seed the two plan the
same path. The JAX side runs in a fresh process whose XLA emits no FMA
(``test_torch_planning_cores`` has the method); one round each, so that
the planning timeout never starts a second.
"""

import numpy as np
import pytest

from kompass_core_tpu_torch.models import Robot, RobotGeometry, RobotType
from kompass_core_tpu_torch.planning import GlobalPlanner, GlobalPlannerConfig

from test_torch_kernels import jax_without_fma
from test_torch_planning_cores import RTOL, wall_points

BATCH_IDS = ("BITstar", "ABITstar", "AITstar")
META = {"resolution": 0.1, "width": 60, "height": 60,
        "origin_x": 0.0, "origin_y": 0.0}
START, GOAL = (1.0, 1.0, 0.0), (1.2, 5.0, 0.0)
CONFIG = dict(seed=5, optimize_rounds=1, planning_timeout=60.0,
              simplification_timeout=60.0)
BATCHES = dict(samples_per_batch=48, batches=3)


def plan(models, planning, planner_id, meta=META, **device):
    """``planner_id``'s path on the small problem, with the GlobalPlanner
    of ``planning`` (either package)."""
    robot = models.Robot(robot_type=models.RobotType.DIFFERENTIAL_DRIVE,
                         geometry_type=models.RobotGeometry.Type.CYLINDER,
                         geometry_params=np.array([0.25, 0.4]))
    cfg = planning.GlobalPlannerConfig(planner_id=planner_id, **CONFIG)
    planner = planning.GlobalPlanner(robot, config=cfg, **device)
    for name, value in BATCHES.items():
        setattr(planner.planner_params, name, value)
    planner.setup_problem(meta, *START, *GOAL, wall_points())
    return planner, planner.solve()


def jax_fields_without_fma():
    from kompass_core_tpu import models, planning

    paths = {}
    for pid in BATCH_IDS:
        _, path = plan(models, planning, pid)
        paths[pid] = np.asarray(path, np.float32)
    return paths


@pytest.fixture(scope="module")
def jax_paths(tmp_path_factory):
    return jax_without_fma("test_torch_planning_front",
                           tmp_path_factory.mktemp("no_fma") / "paths.npz")


class _Port:
    Robot, RobotGeometry, RobotType = Robot, RobotGeometry, RobotType
    GlobalPlanner, GlobalPlannerConfig = GlobalPlanner, GlobalPlannerConfig


@pytest.mark.parametrize("planner_id", BATCH_IDS)
def test_batch_planner_path_equals_jax(jax_paths, planner_id):
    """Same seed, same path: the batches, the roadmap solves, the round's
    choice and the shortcut pass agree."""
    want = jax_paths[planner_id]
    _, got = plan(_Port, _Port, planner_id, device="cpu")
    assert got is not None and len(want) >= 2
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_setup_problem_drops_graphs_of_another_size():
    """The captured chunks (device memory on a card) outlive a new map of
    the same size and go with a map of another size or a configure()."""
    planner, _ = plan(_Port, _Port, "RRT", device="cpu")
    planner._graphs["captured"] = object()
    planner.setup_problem(META, *START, *GOAL, wall_points()[::2])
    assert "captured" in planner._graphs
    planner.setup_problem(dict(META, height=70), *START, *GOAL, wall_points())
    assert not planner._graphs
    planner._graphs["captured"] = object()
    planner._config.max_iterations = 512
    planner.setup_problem(dict(META, height=70), *START, *GOAL, wall_points())
    assert not planner._graphs


def test_configure_drops_graphs(tmp_path):
    import yaml

    planner, _ = plan(_Port, _Port, "RRT", device="cpu")
    planner._graphs["captured"] = object()
    cfg_file = tmp_path / "planner.yaml"
    cfg_file.write_text(yaml.safe_dump({"ompl": {"planner_id": "EST"}}))
    planner.configure(str(cfg_file))
    assert planner.planner_id == "EST" and not planner._graphs
