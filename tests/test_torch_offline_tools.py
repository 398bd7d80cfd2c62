"""The port's offline tools against the JAX package's, on the CPU.

The simulation, motion-cost, calibration and evaluation tools,
``py_path_tools`` and the ``datatypes`` they use (``obstacles``,
``path_sample``, ``pcd``) and ``utils/visualization.py`` are host copies
of the JAX package's modules (NumPy only), so the JAX package's own tests
of them run again against the port (``port_twin`` of
``test_offline_tools.py``, all 13 tests), and the copies give the JAX
package's values exactly.

Two reference faults on record (ROADMAP §3 item 3) are mirrored, not
fixed, since the port is held to the JAX package; each is pinned here:

- ``py_path_tools/executor.py::_augment_path_points``: a midpoint's
  heading is the unwrapped mean of its endpoints' headings, so two
  headings either side of +-pi give a midpoint heading of about 0;
- ``performance.py::MotionEvaluation.export``: only the top level goes
  through ``_finite``, so a non-finite value inside the nested ``tests``
  list is written as a non-standard JSON constant (``Infinity``, ``NaN``).
"""

import json
import math

import numpy as np
import pytest

from kompass_core_tpu import performance as jperformance
from kompass_core_tpu.datatypes import pcd as jpcd
from kompass_core_tpu.datatypes.path_sample import PathSample as JaxPathSample
from kompass_core_tpu.py_path_tools.executor import PathExecutor as JaxPathExecutor
from kompass_core_tpu.py_path_tools import interpolation as jinterp
from kompass_core_tpu.simulation import MotionPaths as JaxMotionPaths
from kompass_core_tpu.utils import visualization as jvis
from kompass_core_tpu_torch import performance as tperformance
from kompass_core_tpu_torch.datatypes import pcd as tpcd
from kompass_core_tpu_torch.datatypes.path_sample import PathSample
from kompass_core_tpu_torch.py_path_tools import interpolation as tinterp
from kompass_core_tpu_torch.py_path_tools.executor import PathExecutor
from kompass_core_tpu_torch.simulation import MotionPaths
from kompass_core_tpu_torch.utils import visualization as tvis

from test_torch_host_modules import port_twin, twin_tests

twin_tests(globals(), port_twin("test_offline_tools"))


def _headings(executor_cls, headings):
    ex = executor_cls()
    ex.start_path_recording()
    for i, h in enumerate(headings):
        ex.record_path_point(float(i), 0.0, h, 0.5)
    assert ex._augment_path_points()
    return [p.heading for p in ex.ref_path]


def test_midpoint_heading_is_the_unwrapped_mean_as_in_jax():
    """Reference fault mirrored: 3.0 and -3.0 rad lie 0.28 rad apart
    across +-pi, yet the midpoint between them gets heading 0.0, their
    unwrapped mean, in the port as in the JAX package."""
    headings = [3.0, -3.0, 3.1, -3.1, 0.5]
    got = _headings(PathExecutor, headings)
    assert got == _headings(JaxPathExecutor, headings)
    assert got[1] == 0.0 and got[3] == pytest.approx(0.05)
    assert got[5] == 0.0


def _exported(module, tmp_path):
    ev = module.MotionEvaluation()
    ok, failed = module.MotionResult(), module.MotionResult()
    ok.reached_end, ok.time_to_goal = True, 4.5
    failed.end_point_error = math.inf
    failed.lateral_error_mean = math.nan
    for r in (ok, failed):
        ev.avg_results.add_test(r)
    with open(ev.export(str(tmp_path))) as f:
        return f.read()


def test_export_sanitises_only_the_top_level_as_in_jax(tmp_path):
    """Reference fault mirrored: the nested per-test entries keep their
    non-finite values, written as ``Infinity`` and ``NaN``, so the file is
    not strict JSON; the port writes the JAX package's file byte for
    byte."""
    text = _exported(tperformance, tmp_path / "port")
    assert text == _exported(jperformance, tmp_path / "jax")
    data = json.loads(text)
    assert data["tests"][1]["end_point_error"] == math.inf
    assert math.isnan(data["tests"][1]["lateral_error_mean"])
    assert data["avg_time_to_goal"] == 4.5

    constants = []
    json.loads(text, parse_constant=lambda c: constants.append(c) or 0.0)
    assert sorted(constants) == ["Infinity", "NaN"]


@pytest.mark.parametrize("gen", ["generate_line_path", "generate_circle_path",
                                 "generate_step_path", "generate_oval_path",
                                 "generate_u_turn_path"])
def test_motion_paths_and_interpolation_equal_jax(gen):
    """The path generators, the spline interpolation and the resampling
    give the JAX package's points exactly."""
    port, ref = getattr(MotionPaths, gen)(), getattr(JaxMotionPaths, gen)()
    for a, b in ((port, ref),
                 (tinterp.interpolate_path(port, max_point_distance=0.07),
                  jinterp.interpolate_path(ref, max_point_distance=0.07)),
                 (tinterp.resample_path(port, 17), jinterp.resample_path(ref, 17))):
        assert isinstance(a, PathSample) and isinstance(b, JaxPathSample)
        for field in ("x_points", "y_points", "heading_points"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


def test_pcd_occupancy_grid_equals_jax(tmp_path):
    """``read_pcd_to_occupancy_grid`` of one seeded ASCII cloud: the same
    points and the same grid."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4.0, 4.0, (500, 3)).astype(np.float32)
    path = tmp_path / "cloud.pcd"
    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
              "COUNT 1 1 1\nWIDTH 500\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              "POINTS 500\nDATA ascii\n")
    path.write_text(header + "\n".join(" ".join(f"{v:.6f}" for v in p) for p in pts))
    np.testing.assert_array_equal(tpcd.read_pcd(str(path)), jpcd.read_pcd(str(path)))
    port = tpcd.read_pcd_to_occupancy_grid(str(path), grid_resolution=0.1,
                                           z_ground_limit=-1.0, robot_height=2.0)
    ref = jpcd.read_pcd_to_occupancy_grid(str(path), grid_resolution=0.1,
                                          z_ground_limit=-1.0, robot_height=2.0)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_visualization_logs_to_the_port_logger():
    assert tvis.logger.name == "kompass_core_tpu_torch"
    assert jvis.logger.name == "kompass_core_tpu"
