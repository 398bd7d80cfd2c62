"""The port's k-tick loop (``DeviceFleet.run_ticks_on_device`` over
``ops/fleet_solver.py::make_fleet_ticks_on_device``) against the JAX
package's, on the CPU.

The cases of ``tests/test_ticks_on_device.py`` run on a JAX and a port
fleet built from the same robots, limits and config, on the same numpy
inputs, and each asserts the JAX test's own contract on the port's
outputs. Per tick and robot the two packages' outputs agree:

- ``found``, ``reached``, ``active_points`` and ``num_admissible`` equal;
- the cost within rel 1e-4 and the command within 1e-4, or a tie (two
  winners whose costs agree within rel 1e-6), as in
  ``tests/test_torch_fleet.py``;
- ``final_states`` within rel 1e-5.

Then ``make_fleet_ticks_on_device`` with 8 tracked slots under the
backends ``"xla"`` (K3), ``"pallas"`` (K7) and ``"pallas_vpu"`` (K8), the
JAX side's Pallas kernels in interpret mode.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.ops import fleet_solver as jfleet
from kompass_core_tpu.ops import pallas_kernels as jpallas
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet as JaxDeviceFleet
from kompass_core_tpu_torch.ops import fleet_solver as tfleet
from kompass_core_tpu_torch.ops import kernels
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.parallel import DeviceFleet

from test_ticks_on_device import N_RAYS, _fleet as _jax_fleet, _inputs
from test_torch_host_modules import to_port

torch.set_num_threads(2)

CMD_TOL = 1e-4
COST_REL = 1e-4
TIE_REL = 1e-6
STATE_REL = 1e-5
EXACT = ("found", "reached", "active_points", "num_admissible", "safety_factor")
COMMAND = ("vx", "vy", "omega")


def _robot_list(n):
    return [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([0.1, 0.4])) for _ in range(n)]


LIMITS = RobotCtrlLimits(
    vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
    omega_limits=AngularCtrlLimits(max_vel=4.0, max_acc=3.0, max_decel=3.0,
                                   max_steer=np.pi),
)


def _lanes(n):
    return [np.array([[1.0 * i, 0.0], [1.0 * i, 2.5]]) for i in range(n)]


def _port_fleet(jf, n_robots, **kw):
    """A port fleet built as ``test_ticks_on_device._fleet`` builds the
    JAX one (the same robots, limits and config), with its paths."""
    fleet = DeviceFleet(*to_port((_robot_list(n_robots), LIMITS)), jf.config,
                        N_RAYS, path_capacity=512, max_segments=16,
                        device="cpu", **kw)
    fleet.set_paths(_lanes(n_robots))
    return fleet


def _pair(n_robots):
    jf = _jax_fleet(n_robots)
    return jf, _port_fleet(jf, n_robots)


def assert_ticks_match(jout, tout):
    """Both packages' [N, k] outputs and final states agree (module
    docstring)."""
    for key in EXACT:
        np.testing.assert_array_equal(tout[key], jout[key], err_msg=key)
    np.testing.assert_allclose(tout["cost"], jout["cost"], rtol=COST_REL,
                               atol=1e-6, err_msg="cost")
    np.testing.assert_allclose(tout["heading_error"], jout["heading_error"],
                               atol=CMD_TOL, err_msg="heading_error")
    cmd_t = np.stack([tout[k] for k in COMMAND], axis=-1)
    cmd_j = np.stack([jout[k] for k in COMMAND], axis=-1)
    for r, i in np.argwhere(np.abs(cmd_t - cmd_j).max(axis=-1) > CMD_TOL):
        assert abs(tout["cost"][r, i] - jout["cost"][r, i]) <= (
            TIE_REL * abs(jout["cost"][r, i])), (
            f"robot {r} tick {i}: command {cmd_t[r, i]} vs JAX {cmd_j[r, i]} "
            "is not a tie")
    np.testing.assert_allclose(tout["final_states"], jout["final_states"],
                               rtol=STATE_REL, atol=1e-6, err_msg="final_states")


def test_first_tick_matches_single_tick():
    n = 2
    jf, tf = _pair(n)
    single = _port_fleet(jf, n)
    states, vels, ranges, angles = _inputs(n)
    jout = jf.run_ticks_on_device(4, states, vels, ranges, angles)
    tout = tf.run_ticks_on_device(4, states, vels, ranges, angles)
    assert_ticks_match(jout, tout)
    one = single.tick(states, vels, ranges, angles)
    for f in ("found", "reached", "vx", "vy", "omega", "cost"):
        np.testing.assert_allclose(
            tout[f][:, 0].astype(np.float64), one[f].astype(np.float64),
            rtol=1e-5, atol=1e-6,
            err_msg=f"tick 0 of the K-loop diverges from tick() on {f}",
        )


def test_k_ticks_reach_goal_on_device():
    jf, tf = _pair(1)
    states, vels, ranges, angles = _inputs(1)
    jout = jf.run_ticks_on_device(60, states, vels, ranges, angles)
    out = tf.run_ticks_on_device(60, states, vels, ranges, angles)
    assert_ticks_match(jout, out)
    assert out["reached"].shape == (1, 60)
    assert out["reached"][0, -1], "robot did not reach goal within 60 ticks"
    fx, fy = out["final_states"][0, :2]
    assert abs(fx - 0.0) < 0.3 and abs(fy - 2.5) < 0.3, (fx, fy)
    assert abs(out["vx"][0, -1]) < 1e-6
    # the carry persists: a follow-up call starts already reached
    jout2 = jf.run_ticks_on_device(4, jout["final_states"], vels, ranges, angles)
    out2 = tf.run_ticks_on_device(4, out["final_states"], vels, ranges, angles)
    assert_ticks_match(jout2, out2)
    assert out2["reached"].all()


def test_per_tick_axis_evolves():
    """Commands differ across the k axis: the state integrates (a frozen
    carry would repeat one command)."""
    jf, tf = _pair(1)
    states, vels, ranges, angles = _inputs(1)
    jout = jf.run_ticks_on_device(20, states, vels, ranges, angles)
    out = tf.run_ticks_on_device(20, states, vels, ranges, angles)
    assert_ticks_match(jout, out)
    assert np.std(out["vx"][0]) > 1e-3, out["vx"][0]


def test_boxed_in_robot_holds_instead_of_marching():
    """No admissible sample: a zero command every tick, and the state
    holds at the initial pose."""
    jf, tf = _pair(1)
    states, vels, ranges, angles = _inputs(1)
    ranges = np.full((1, N_RAYS), 0.15)
    jout = jf.run_ticks_on_device(5, states, vels, ranges, angles)
    out = tf.run_ticks_on_device(5, states, vels, ranges, angles)
    assert_ticks_match(jout, out)
    assert not out["found"].any(), "no sample should be admissible"
    np.testing.assert_array_equal(out["vx"], np.zeros((1, 5)))
    np.testing.assert_array_equal(out["omega"], np.zeros((1, 5)))
    np.testing.assert_allclose(out["final_states"][0, :3], states[0, :3], atol=1e-6)
    one = tf.tick(states, vels, ranges, angles)
    assert not one["found"].any() and one["vx"][0] == 0.0


def test_k_must_be_positive():
    _, tf = _pair(1)
    with pytest.raises(ValueError, match="k >= 1"):
        tf.run_ticks_on_device(0, *_inputs(1))
    with pytest.raises(ValueError, match="k >= 1"):
        tfleet.make_fleet_ticks_on_device(tf.spec, 0, "cpu")


# --- make_fleet_ticks_on_device with tracked movers, per backend -------------

M = 8
K = 5


@pytest.fixture
def jax_pallas_interpret(monkeypatch):
    """The JAX package's Pallas sweeps in interpret mode (the k-loop's
    solve passes no ``interpret`` to its moving sweep)."""
    fused = jpallas.fused_min_dist_sq
    monkeypatch.setattr(jpallas, "fused_min_dist_sq",
                        lambda *a, **k: fused(*a, **{**k, "interpret": True}))


def _tracked_inputs(n):
    """Robots a few cm off their lanes, heading slightly off them (no
    mirror-image ties), a random scan, one mover crossing ahead of each
    robot and one standing beside it; the other slots empty."""
    rng = np.random.default_rng(17)
    states, vels, _, angles = _inputs(n)
    states[:, 0] += 0.031
    states[:, 2] += 0.07
    vels[:, 0] = 0.4
    ranges = rng.uniform(0.9, 10.0, (n, N_RAYS))
    trk = np.full((n, M, 4), np.nan, np.float32)
    trk[:, 0] = (0.9, 1.2, -0.45, 0.0)
    trk[:, 0, 0] += np.arange(n)
    trk[:, 1] = (-0.6, 0.5, 0.0, 0.0)
    trk[:, 1, 0] += np.arange(n)
    return states, vels, ranges, angles, trk


@pytest.mark.parametrize("backend,kernel", [("xla", "K3"), ("pallas", "K7"),
                                            ("pallas_vpu", "K8")])
def test_tracked_ticks_on_device_match_jax_per_backend(
        jax_pallas_interpret, monkeypatch, backend, kernel):
    n = 2
    jf = JaxDeviceFleet(_robot_list(n), LIMITS, _jax_fleet(1).config, N_RAYS,
                        path_capacity=512, max_segments=16, tracked_obstacles=M)
    jf.set_paths(_lanes(n))
    tf = _port_fleet(jf, n, tracked_obstacles=M)
    inputs = _tracked_inputs(n)
    jf._prepare_tick_inputs(*inputs)
    tf._prepare_tick_inputs(*inputs)
    np.testing.assert_array_equal(tf._inputs, jf._inputs)
    jspec = dataclasses.replace(jf.spec, solver=dataclasses.replace(
        jf.spec.solver, backend=backend))
    tspec = dataclasses.replace(tf.spec, solver=dataclasses.replace(
        tf.spec.solver, backend=backend))
    assert tfleet.fleet_spec_from_jax(jspec) == tspec
    jcarry, jouts, jfinal = jfleet.make_fleet_ticks_on_device(jspec, K)(
        jf._paths, jf._cfg, jf._carry, jf._angles, jnp.asarray(jf._inputs))
    calls = []
    wrapper = kernels.SWEEP_KERNELS[kernel]
    monkeypatch.setattr(tsolver, wrapper.__name__,
                        lambda *a: calls.append(1) or wrapper(*a))
    tcarry, touts, tfinal = tfleet.make_fleet_ticks_on_device(tspec, K, "cpu")(
        tf._paths, tf._cfg, tf._carry, tf._angles, torch.from_numpy(tf._inputs))
    assert len(calls) == K  # drop mode: one sweep per tick
    F = tfleet.OUT_FIELDS
    pack = lambda outs, fin: dict(  # noqa: E731
        {f: np.asarray(outs)[:n, :, i] for i, f in enumerate(F)},
        final_states=np.asarray(fin)[:n])
    jout, tout = pack(jouts, jfinal), pack(touts.numpy(), tfinal.numpy())
    assert_ticks_match(jout, tout)
    assert tout["found"].all() and np.abs(tout["vx"]).max() > 0.1
    for jv, tv in zip(jcarry, tcarry):
        np.testing.assert_allclose(tv.numpy().astype(np.float64),
                                   np.asarray(jv).astype(np.float64), rtol=1e-5)
