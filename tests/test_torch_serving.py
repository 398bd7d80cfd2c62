"""The port's serving artifacts, kernel operators, logger and runtime
helpers, on the CPU.

- The JAX package's own serving tests (``test_serving_export.py``, all 17)
  run again against the port through ``port_twin``, with the port's
  device rule (``device=CPU`` at every export and load), its version key
  (``torch_version``), its platforms (``("cpu", "cuda")``) and four CPU
  ``torch.device``s in place of XLA's virtual devices for the sharded
  serving tests (``torch_twin_adapters.serving_replace``, a function of
  the device, which ``test_torch_twin_cuda_main.py`` gives the card).
  None is left out.
- The port's own: each served program's graph holds the kernels as
  ``kompass_torch::`` operators, as many as its path launches, and its
  export traces no plain sweep (each plain version raises meanwhile); served == live bit for bit for the packed solver at each
  backend and for a tracked fleet's tick and k-tick loop; a JAX artifact
  and a device type an artifact does not list are refused; a snapshot
  written by the JAX package's fleet resumes in the port's.
- Every kernel operator's CPU implementation is its plain version, its
  fake implementation gives the shapes and dtypes, and no wrapper picks
  an implementation by device in Python.
- The logger and the runtime helpers.
"""

import dataclasses
import inspect
import logging

import numpy as np
import pytest
import torch

from kompass_core_tpu.ops.solver import SolverSpec as JaxSolverSpec
from kompass_core_tpu.serving import export_packed_solver as jax_export_packed_solver
from kompass_core_tpu_torch import serving
from kompass_core_tpu_torch.ops import kernels
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.parallel import DeviceFleet
from kompass_core_tpu_torch.utils import logger as tlogger
from kompass_core_tpu_torch.utils import runtime

from test_torch_fleet import assert_rows_match
from test_torch_host_modules import port_twin, twin_tests
from torch_twin_adapters import serving_env, serving_replace

import test_serving_export as jax_serving

CPU = torch.device("cpu")

twin = port_twin("test_serving_export", replace=serving_replace(CPU), env=serving_env(CPU))
twin_tests(globals(), twin)

SPEC = twin.SPEC


def _kernel_nodes(art):
    """The served graph's kernel operators by name."""
    return sorted(str(n.target).split(".")[1] for n in art.program.graph.nodes
                  if str(n.target).startswith("kompass_torch."))


@pytest.fixture
def no_plain_sweep(monkeypatch):
    """While it is active, running any kernel's plain version raises: an
    export traces the operators' fake implementations only, so a graph
    that would carry a plain sweep fails to export."""

    def plain(*args, **kw):
        raise AssertionError("a plain version was traced into the graph")

    for name in ("_sweep_reference", "box_min_dist_sq_reference",
                 "scan_to_grid_cells_reference"):
        monkeypatch.setattr(kernels, name, plain)
    return monkeypatch


# (backend, the kernel operators one packed solve launches)
_SOLVER_KERNELS = [
    ("xla", ["fused_min_dist_sq"]),
    ("pallas", ["fused_min_dist_sq_expanded"]),
    ("pallas_vpu", ["fused_min_dist_sq_broadcast"]),
    ("pallas_v1", ["min_dist_sq_expanded", "min_dist_sq_expanded"]),
]


@pytest.mark.parametrize("backend,ops", _SOLVER_KERNELS)
def test_served_packed_solver_equals_live_at_each_backend(tmp_path, no_plain_sweep,
                                                        backend, ops):
    """Each backend's packed solver, exported and loaded on the CPU, gives
    the live solver's output bit for bit on two buffers; its graph holds
    the backend's kernels as operators (and the export traced no plain
    sweep)."""
    spec = dataclasses.replace(SPEC, backend=backend)
    path = str(tmp_path / f"{backend}.ktpuart")
    serving.export_packed_solver(spec, path, device=CPU)
    no_plain_sweep.undo()
    art, loaded = serving.load_packed_solver(path, device=CPU)
    assert loaded == spec and art.device == CPU
    assert _kernel_nodes(art) == ops
    assert not any(n.meta.get("stack_trace") for n in art.program.graph.nodes)
    live = tsolver.get_packed_dwa_solver(spec, CPU)
    buf = twin._packed_buffer(SPEC)
    for b in (buf, buf * np.float32(0.97)):
        assert torch.equal(art.call(b), live(b))


def test_served_tracked_fleet_tick_and_loop_equal_live(tmp_path, no_plain_sweep):
    """A 3-robot fleet with 2 tracked slots and a live mover: the tick
    artifact (one K3) and the k = 2 artifact (two), exported with no plain
    sweep traced, equal the live tick and the live loop bit for bit, carry
    included, over 3 chained calls."""
    fleet = _tracked_port_fleet()
    paths = {}
    for k in (None, 2):
        paths[k] = str(tmp_path / f"fleet_{k}.ktpuart")
        if k is None:
            serving.export_fleet_tick(fleet, paths[k], device=CPU)
        else:
            serving.export_fleet_ticks_on_device(fleet, k, paths[k], device=CPU)
    no_plain_sweep.undo()
    for k, path in paths.items():
        art = serving.load_artifact(path, device=CPU)
        assert art.meta["tracked_obstacles"] == 2
        assert _kernel_nodes(art) == ["fused_min_dist_sq_moving"] * (k or 1)
        live_fn = fleet._tick_fn if k is None else fleet.ticks_fn(k)
        args = fleet.tick_example_args()
        live_args, served_args = args, args
        for _ in range(3):
            live, served = live_fn(*live_args), art.call(*served_args)
            for a, b in zip(torch.utils._pytree.tree_leaves(live),
                            torch.utils._pytree.tree_leaves(served)):
                assert torch.equal(a, b)
            live_args = (*args[:2], live[0], *args[3:])
            served_args = (*args[:2], served[0], *args[3:])


def _tracked_port_fleet():
    from kompass_core_tpu_torch.control import DWAConfig, TrajectoryCostsWeights
    from kompass_core_tpu_torch.models import (
        AngularCtrlLimits, LinearCtrlLimits, Robot, RobotCtrlLimits,
        RobotGeometry, RobotType,
    )

    robots = [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                    geometry_type=RobotGeometry.Type.CYLINDER,
                    geometry_params=np.array([0.1, 0.4])) for _ in range(3)]
    limits = RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=4.0, max_acc=3.0, max_decel=3.0,
                                       max_steer=np.pi))
    config = DWAConfig(
        max_linear_samples=4, max_angular_samples=4, prediction_horizon=8,
        control_horizon=2, control_time_step=0.1,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            obstacles_distance_weight=0.5))
    fleet = DeviceFleet(robots, limits, config, scan_rays=twin.N_RAYS,
                        path_capacity=512, max_segments=16, tracked_obstacles=2,
                        device=CPU)
    fleet.set_paths([np.array([[0.0, float(i)], [3.0, float(i)]]) for i in range(3)])
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, twin.N_RAYS, endpoint=False))
    fleet._inputs[:3, 4] = 0.3
    fleet._inputs[:3, 7:7 + twin.N_RAYS] = 10.0
    fleet._write_tracked([np.array([[0.8, 0.1, 0.0, -0.5]], np.float32),
                          np.zeros((0, 4), np.float32),
                          np.array([[1.2, 2.0, -0.4, 0.0]], np.float32)])
    return fleet


def test_tick_example_args_need_paths_and_angles():
    fleet = twin._make_fleet()
    with pytest.raises(RuntimeError, match="set_paths"):
        fleet.tick_example_args()
    fleet.set_paths([np.array([[0.0, float(i)], [3.0, float(i)]]) for i in range(3)])
    with pytest.raises(RuntimeError, match="set_scan_angles"):
        fleet.tick_example_args()
    fleet.set_scan_angles(np.linspace(0, 2 * np.pi, twin.N_RAYS, endpoint=False))
    paths, cfg, carry, angles, inputs = fleet.tick_example_args()
    assert paths is fleet._paths and carry is fleet._carry
    assert inputs.dtype == torch.float32 and inputs.shape == fleet._inputs.shape


def test_jax_artifact_is_refused(tmp_path):
    """The containers share their magic; a header with ``jax_version`` and
    no ``torch_version`` is the JAX package's, which the port cannot run."""
    path = str(tmp_path / "jax.ktpuart")
    jax_export_packed_solver(JaxSolverSpec(**dataclasses.asdict(SPEC)), path)
    header = serving.read_artifact_header(path)
    assert "jax_version" in header and "torch_version" not in header
    for load in (serving.load_artifact, serving.load_packed_solver):
        with pytest.raises(ValueError, match="JAX"):
            load(path, device=CPU)


def test_a_device_type_the_artifact_does_not_list_is_refused(tmp_path):
    """A CPU-only artifact refuses ``cuda`` before anything touches a card
    (``torch.device("cuda")`` needs none); exporting on a device type that
    ``platforms`` leaves out is refused too; no function defaults its
    device."""
    path = str(tmp_path / "cpu.ktpuart")
    header = serving.export_packed_solver(SPEC, path, device=CPU)
    assert header["platforms"] == ["cpu"] and header["device"] == "cpu"
    assert header["cuda"] == torch.version.cuda
    for load in (serving.load_artifact, serving.load_packed_solver):
        with pytest.raises(ValueError, match="not for cuda"):
            load(path, device=torch.device("cuda"))
        with pytest.raises(TypeError, match="device"):
            load(path)
    with pytest.raises(ValueError, match="platforms"):
        serving.export_packed_solver(SPEC, path, device=CPU, platforms=("cuda",))
    for fn in (serving.export_callable, serving.export_packed_solver,
               serving.export_fleet_tick, serving.export_fleet_ticks_on_device,
               serving.load_artifact, serving.load_packed_solver):
        param = inspect.signature(fn).parameters["device"]
        assert param.kind is param.KEYWORD_ONLY and param.default is param.empty


def test_jax_snapshot_resumes_in_the_port_fleet(tmp_path):
    """A snapshot written by the JAX package's fleet after 4 ticks, through
    a disk round trip, resumes in a fresh port fleet: its next 3 ticks
    equal the JAX fleet's under the fleet lockstep rule
    (``test_torch_fleet.assert_rows_match``)."""
    jax_fleet = jax_serving._make_fleet()
    jax_serving._prime_fleet(jax_fleet)
    for step in range(4):
        jax_fleet.tick(*jax_serving._tick_inputs(step))
    np.savez(tmp_path / "fleet_state.npz", **jax_fleet.state_dict())
    sd = dict(np.load(str(tmp_path / "fleet_state.npz")))
    port = twin._make_fleet()
    port.load_state_dict(sd)
    for s in range(3):
        inputs = twin._tick_inputs(4 + s)
        assert_rows_match(jax_fleet.tick(*inputs), port.tick(*inputs), f"tick {s}")


# --- the kernels as operators -------------------------------------------------


def _sweep_args(rng, B=2, S=7, T=5, O=9, G=4):
    f = lambda *shape: torch.tensor(rng.uniform(-3, 3, shape), dtype=torch.float32)
    ap = torch.tensor(rng.integers(1, T + 1, B), dtype=torch.int32)
    return dict(px=f(B, S, T), py=f(B, S, T), obs=f(B, O, 2), vel=f(B, O, 2),
                dt=torch.full((B,), 0.1), sx=f(B, G), sy=f(B, G), ap=ap,
                cos=f(B, S, T), sin=f(B, S, T), half=torch.abs(f(B, 2)))


def _op_calls(a):
    """(PERF.md name, the operator's arguments, the wrapper's call, the
    plain version's call) for every sweep kernel."""
    static = (a["px"], a["py"], a["obs"], a["sx"], a["sy"], a["ap"])
    moving = (a["px"], a["py"], a["obs"], a["vel"], a["dt"], a["sx"], a["sy"], a["ap"])
    box = (a["px"], a["py"], a["cos"], a["sin"], a["obs"], a["vel"], a["dt"],
           a["half"], a["ap"])
    k = kernels
    return [
        ("K1", static + (0,), k.fused_min_dist_sq(*static),
         k.fused_min_dist_sq_reference(*static)),
        ("K2", static + (0,), k.fused_min_dist_sq_expanded(*static),
         k.fused_min_dist_sq_expanded_reference(*static)),
        ("K6", static + (0,), k.fused_min_dist_sq_broadcast(*static),
         k.fused_min_dist_sq_broadcast_reference(*static)),
        ("K4", (a["px"], a["py"], a["obs"], a["ap"], 0),
         k.min_dist_sq_expanded(a["px"], a["py"], a["obs"], a["ap"]),
         k.min_dist_sq_expanded_reference(a["px"], a["py"], a["obs"], a["ap"])),
        ("K3", moving, k.fused_min_dist_sq_moving(*moving),
         k.fused_min_dist_sq_reference(*static[:5], a["ap"], a["vel"], a["dt"])),
        ("K7", moving, k.fused_min_dist_sq_moving_expanded(*moving),
         k.fused_min_dist_sq_moving_expanded_reference(*moving)),
        ("K8", moving, k.fused_min_dist_sq_moving_broadcast(*moving),
         k.fused_min_dist_sq_moving_broadcast_reference(*moving)),
        ("K3s", (a["px"], a["py"], a["obs"], a["vel"], a["dt"], a["ap"], -1),
         k.min_dist_sq_moving(a["px"], a["py"], a["obs"], a["vel"], a["dt"], a["ap"]),
         k.min_dist_sq_moving_reference(a["px"], a["py"], a["obs"], a["vel"],
                                        a["dt"], a["ap"])),
        ("K9", box + (0,), k.box_min_dist_sq(*box), k.box_min_dist_sq_reference(*box)),
    ]


def test_every_sweep_operator_runs_its_plain_version_on_the_cpu():
    """Operator, wrapper and plain version agree bit for bit on CPU
    tensors, and no launch is counted; under ``FakeTensorMode`` the
    operator gives its outputs' shapes and dtypes only."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    before = kernels.launch_counts()
    calls = _op_calls(_sweep_args(np.random.default_rng(0)))
    assert sorted(key for key, *_ in calls) == sorted(kernels.SWEEP_KERNELS)
    for key, args, wrapped, plain in calls:
        got = kernels.OPS[key](*args)
        for out in (got, wrapped):
            for a, b in zip(torch.utils._pytree.tree_leaves(out),
                            torch.utils._pytree.tree_leaves(plain)):
                assert torch.equal(a, b), key
    assert kernels.launch_counts() == before
    with FakeTensorMode() as mode:
        fake = {k: mode.from_tensor(v) if isinstance(v, torch.Tensor) else v
                for k, v in _sweep_args(np.random.default_rng(0)).items()}
        static = (fake["px"], fake["py"], fake["obs"], fake["sx"], fake["sy"], fake["ap"])
        d2_obs, d2_seg = kernels.OPS["K1"](*static, 0)
        box = kernels.OPS["K9"](fake["px"], fake["py"], fake["cos"], fake["sin"],
                                fake["obs"], None, None, fake["half"], fake["ap"], 0)
    for out in (d2_obs, d2_seg, box):
        assert out.shape == (2, 7, 5) and out.dtype == torch.float32


def test_scan_to_grid_operator_runs_its_plain_version_on_the_cpu():
    """K5's operator in both forms: the plain form's second output is
    empty, the wrapper returns the occupancy alone; the Bayesian form's
    pair equals the plain version's."""
    rng = np.random.default_rng(1)
    H, W, B, R = 9, 11, 16, 2
    base = torch.tensor(rng.integers(0, B, (H, W)), dtype=torch.int32)
    dist = torch.tensor(rng.uniform(0, 2, (H, W)), dtype=torch.float32)
    tables = torch.tensor(np.stack([rng.integers(0, H, (R, B)), rng.integers(0, W, (R, B)),
                                    rng.integers(0, 1 << 20, (R, B)),
                                    rng.integers(0, 2, (R, B))], -1), dtype=torch.int32)
    endpoint = torch.tensor(rng.integers(0, 2, (R, H, W)), dtype=torch.bool)
    prev = torch.full((R, H, W), 0.5)
    params = torch.tensor([0.6, 0.1, 0.9, 0.1, 20.0, 0.2, 0.4 / 0.6])
    occ, empty = kernels.OPS["K5"](base, dist, tables, endpoint, 4, 5, None, None)
    want = kernels.scan_to_grid_cells_reference(base, dist, tables, endpoint, (4, 5))
    assert torch.equal(occ, want) and empty.numel() == 0
    assert torch.equal(kernels.scan_to_grid_cells(base, dist, tables, endpoint, (4, 5)), want)
    got = kernels.OPS["K5"](base, dist, tables, endpoint, 4, 5, prev, params)
    want = kernels.scan_to_grid_cells_reference(base, dist, tables, endpoint, (4, 5),
                                                prev, params)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_no_wrapper_picks_its_implementation_by_device():
    """The wrappers hand every call to their operator, which the
    dispatcher routes by device: none branches on a device in Python."""
    wrappers = [*kernels.SWEEP_KERNELS.values(), kernels.scan_to_grid_cells]
    for wrapper in wrappers:
        src = inspect.getsource(wrapper)
        assert "device" not in src.split('"""')[-1], wrapper.__name__
        assert f"torch.ops.kompass_torch.{wrapper.__name__}(" in src
    assert len(kernels.OPS) == 10


# --- the logger and the runtime helpers ----------------------------------------


def test_logger_level_file_and_accelerators(tmp_path):
    import kompass_core_tpu_torch as port

    log = logging.getLogger("kompass_core_tpu_torch")
    level = log.level
    try:
        port.set_logging_level("warning")
        assert log.level == logging.WARNING and port.set_log_level is tlogger.set_log_level
        for name in ("a.log", "b.log"):
            port.set_log_file(str(tmp_path / name))
            log.warning("to %s", name)
        handlers = [h for h in log.handlers if isinstance(h, logging.FileHandler)]
        assert [h.baseFilename for h in handlers] == [str(tmp_path / "b.log")]
        for h in handlers:
            h.flush()
        assert "to a.log" in (tmp_path / "a.log").read_text()
        assert "to b.log" in (tmp_path / "b.log").read_text()
    finally:
        for h in [h for h in log.handlers if isinstance(h, logging.FileHandler)]:
            log.removeHandler(h)
            h.close()
        tlogger._file_handler = None
        log.setLevel(level)
    accelerators = port.get_available_accelerators()
    assert accelerators[-1] == "cpu"
    assert len(accelerators) == torch.cuda.device_count() + 1


def test_runtime_helpers_on_a_host_without_a_card(monkeypatch, tmp_path, caplog):
    """Here the probe finds no card: ``probe_backend`` returns None with
    its reason, ``require_backend_or_cpu`` returns the CPU with a warning
    (``KOMPASS_TPU_FORCE_CPU`` skips its probe); the build cache moves
    where it is told, unless ``KOMPASS_TPU_NO_CACHE`` is set."""
    assert runtime.probe_backend(30.0) is None
    assert runtime.probe_backend.last_error
    with caplog.at_level(logging.WARNING, logger="kompass_core_tpu_torch"):
        assert runtime.require_backend_or_cpu(120.0) == CPU
    assert "running on CPU" in caplog.text
    monkeypatch.setenv("KOMPASS_TPU_FORCE_CPU", "1")
    assert runtime.require_backend_or_cpu() == CPU
    monkeypatch.setattr(runtime, "_cache_enabled", False)
    monkeypatch.setattr(kernels, "BUILD_DIR", kernels.BUILD_DIR)
    monkeypatch.setenv("KOMPASS_TPU_NO_CACHE", "1")
    runtime.enable_persistent_compilation_cache(str(tmp_path))
    assert kernels.BUILD_DIR != tmp_path
    monkeypatch.delenv("KOMPASS_TPU_NO_CACHE")
    runtime.enable_persistent_compilation_cache(str(tmp_path))
    assert kernels.BUILD_DIR == tmp_path
    assert kernels.library_path().parent.parent == tmp_path


def test_a_cpu_artifact_moves_to_the_device_it_is_loaded_on(tmp_path):
    """An artifact traced on the CPU and loaded on another device type its
    ``platforms`` list runs there with no tensor left on the CPU: here the
    ``meta`` device (shapes only: the kernels' operators run their fake
    implementation), for the packed solver, the fleet tick and the k-tick
    loop; on the card, ``cuda`` (``tests/test_torch_cuda.py``)."""
    fleet = _tracked_port_fleet()
    meta = torch.device("meta")
    exports = {
        "solver": lambda p: serving.export_packed_solver(
            SPEC, p, device=CPU, platforms=("cpu", "meta")),
        "tick": lambda p: serving.export_fleet_tick(
            fleet, p, device=CPU, platforms=("cpu", "meta")),
        "ticks": lambda p: serving.export_fleet_ticks_on_device(
            fleet, 2, p, device=CPU, platforms=("cpu", "meta")),
    }
    for name, export in exports.items():
        path = str(tmp_path / f"{name}.ktpuart")
        export(path)
        art = serving.load_artifact(path, device=meta)
        assert art.device == meta
        if name == "solver":
            args = (torch.empty(tsolver.packed_input_size(SPEC), device=meta),)
        else:
            args = torch.utils._pytree.tree_map(lambda t: t.to(meta),
                                                fleet.tick_example_args())
        for out in torch.utils._pytree.tree_leaves(art.call(*args)):
            assert out.device == meta
        assert all(t.device == meta for t in art.program.constants.values()
                   if isinstance(t, torch.Tensor))
