"""The port's fleet peer avoidance and prediction (``ops/fleet_solver.py``,
``parallel/fleet_v2.py``, item 5c) against the JAX package's, on the CPU.

Both packages' fleets are built from the same robots, limits and config
(the port's own host objects, ``to_port``, for the port's fleet) and run
in lockstep on the same numpy inputs; the states advance with the JAX
commands. Per tick and robot ``found``, ``reached``, ``active_points``
and ``num_admissible`` are equal, the cost within rel 1e-4, the command
within 1e-4 or a tie (two winners whose costs agree within rel 1e-6),
``final_states`` within rel 1e-5, and the safety factor within
``test_torch_safety.SAFETY_ATOL`` (``assert_rows_close``). The cases are
``tests/test_fleet_v2.py``'s head-on peers, single-robot identity and
peers in the k-tick loop, plus 4 robots in head-on and crossing pairs
with and without prediction, with the safety gate, and the peer k-tick
loop per backend (the JAX side's Pallas kernels in interpret mode). The
JAX fleets are built once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kompass_core_tpu.control import DWAConfig, TrajectoryCostsWeights
from kompass_core_tpu.models import (
    AngularCtrlLimits,
    LinearCtrlLimits,
    Robot,
    RobotCtrlLimits,
    RobotGeometry,
    RobotType,
)
from kompass_core_tpu.ops import fleet_solver as jfleet
from kompass_core_tpu.parallel.fleet_v2 import DeviceFleet as JaxDeviceFleet
from kompass_core_tpu.parallel.fleet_v2 import FleetSafetyConfig as JaxSafety
from kompass_core_tpu_torch.ops import fleet_solver as tfleet
from kompass_core_tpu_torch.ops import kernels
from kompass_core_tpu_torch.ops import solver as tsolver
from kompass_core_tpu_torch.parallel import DeviceFleet, FleetMesh
from kompass_core_tpu_torch.parallel.fleet_v2 import FleetSafetyConfig

from test_torch_host_modules import to_port
from test_torch_safety import assert_rows_close
from test_torch_ticks import jax_pallas_interpret  # noqa: F401 (fixture)

torch.set_num_threads(2)

N_RAYS = 64
ANGLES = np.linspace(0, 2 * np.pi, N_RAYS, endpoint=False)
DT = 0.1
CONTACT = 0.55  # two r = 0.3 discs touch at 0.6


def _robots(n, radius=0.3):
    return [Robot(robot_type=RobotType.DIFFERENTIAL_DRIVE,
                  geometry_type=RobotGeometry.Type.CYLINDER,
                  geometry_params=np.array([radius, 0.4])) for _ in range(n)]


def _limits():
    return RobotCtrlLimits(
        vx_limits=LinearCtrlLimits(max_vel=1.0, max_acc=5.0, max_decel=10.0),
        omega_limits=AngularCtrlLimits(max_vel=4.0, max_acc=3.0, max_decel=3.0,
                                       max_steer=np.pi),
    )


def _config(samples, obstacles_weight=0.0):
    return DWAConfig(
        max_linear_samples=samples, max_angular_samples=samples,
        costs_weights=TrajectoryCostsWeights(
            reference_path_distance_weight=3.0, goal_distance_weight=1.0,
            smoothness_weight=0.0, jerk_weight=0.0,
            obstacles_distance_weight=obstacles_weight,
        ),
        prediction_horizon=10, control_horizon=2, control_time_step=DT,
    )


def _fleet(pkg, n, peer=True, predict=False, safety=False, samples=4,
           obstacles_weight=0.0):
    """``test_fleet_v2._make_peer``'s fleet (4 x 4 samples, r = 0.3) of
    ``pkg``; the 4-robot scenes take 9 x 9 samples and the safety gate."""
    kw = dict(scan_rays=N_RAYS, path_capacity=512, max_segments=16,
              peer_avoidance=peer, peer_prediction=predict)
    config = _config(samples, obstacles_weight)
    if pkg == "jax":
        return JaxDeviceFleet(_robots(n), _limits(), config,
                              safety_config=JaxSafety() if safety else None, **kw)
    return DeviceFleet(*to_port((_robots(n), _limits())), config,
                       safety_config=FleetSafetyConfig() if safety else None,
                       device="cpu", **kw)


# name -> _fleet's arguments after the package
FLEETS = {
    "head_on": (2,),
    "head_on_plain": (2, False),
    "lone": (1,),
    "lone_plain": (1, False),
    "pairs": (4, True, False, True, 9, 0.5),
    "pairs_predict": (4, True, True, True, 9, 0.5),
}


@pytest.fixture(scope="module")
def jax_fleets():
    """The JAX fleets, built (and compiled) once for the module; every
    test sets their paths, which resets their carry."""
    return {name: _fleet("jax", *args) for name, args in FLEETS.items()}


def _pair(jax_fleets, name, paths):
    fleets = jax_fleets[name], _fleet("port", *FLEETS[name])
    for f in fleets:
        f.set_paths(paths)
    return fleets


def _advance(states, out):
    """Integrate every robot's command for one step, as the k-tick loop
    does (position from the pre-update heading)."""
    s = states.copy()
    vx, vy, om = out["vx"], out["vy"], out["omega"]
    c, sn = np.cos(s[:, 2]), np.sin(s[:, 2])
    s[:, 0] += DT * (vx * c - vy * sn)
    s[:, 1] += DT * (vx * sn + vy * c)
    s[:, 2] += DT * om
    s[:, 3] = np.hypot(vx, vy)
    return s.astype(np.float32), np.stack([vx, vy, om], 1).astype(np.float32)


def _min_distance(states):
    """The closest pair's center distance (inf for one robot)."""
    d = np.hypot(states[:, None, 0] - states[None, :, 0],
                 states[:, None, 1] - states[None, :, 1])
    return d[~np.eye(len(states), dtype=bool)].min(initial=np.inf)


def lockstep(fleets, states, ticks, ranges=None):
    """Tick both fleets on the same inputs, advance with the JAX command;
    returns (the port's outputs per tick, the closest approach)."""
    n = len(states)
    ranges = np.full((n, N_RAYS), 10.0, np.float32) if ranges is None else ranges
    vels = np.zeros((n, 3), np.float32)
    outs, min_d = [], _min_distance(states)
    for tick in range(ticks):
        jout, tout = (f.tick(states, vels, ranges, ANGLES) for f in fleets)
        assert_rows_close(jout, tout, f"tick {tick}")
        outs.append(tout)
        states, vels = _advance(states, jout)
        min_d = min(min_d, _min_distance(states))
    return outs, min_d


HEAD_ON_PATHS = [np.array([[0.0, 0.0], [4.0, 0.0]]), np.array([[4.0, 0.0], [0.0, 0.0]])]
HEAD_ON_STATES = np.array([[0.0, 0.0, 0.0, 0.0], [4.0, 0.0, np.pi, 0.0]], np.float32)


# --- construction --------------------------------------------------------------


@pytest.mark.parametrize("predict", [False, True])
def test_peer_spec_and_config_match_jax(jax_fleets, predict):
    jf = jax_fleets["pairs_predict" if predict else "pairs"]
    tf = _fleet("port", *FLEETS["pairs_predict" if predict else "pairs"])
    assert tfleet.fleet_spec_from_jax(jf.spec) == tf.spec
    assert tf.spec.solver.moving_obstacles == predict
    assert tf._peer_cfg.keys() == jf._peer_cfg.keys()
    for key, value in jf._peer_cfg.items():
        np.testing.assert_array_equal(tf._peer_cfg[key], value, err_msg=key)


def test_peer_prediction_requires_avoidance_and_the_moving_sweep():
    with pytest.raises(ValueError, match="peer_avoidance"):
        _fleet("port", 2, peer=False, predict=True)
    spec = _fleet("port", 2).spec  # no prediction: the static sweep
    cfg = {"radii": np.full(2, 0.3, np.float32), "n_real": 2, "ring": 8,
           "predict": True}
    for make in (lambda: tfleet.make_fleet_tick(spec, "cpu", peer_cfg=cfg),
                 lambda: tfleet.make_fleet_ticks_on_device(spec, 2, "cpu", peer_cfg=cfg)):
        with pytest.raises(ValueError, match="moving_obstacles"):
            make()
    # the mesh form (item 5g) builds, and refuses a device beside its mesh
    mesh = FleetMesh(["cpu"] * 2)
    for kw in (dict(peer_cfg=dict(cfg, predict=False), mesh=mesh),):
        with pytest.raises(ValueError, match="not both"):
            tfleet.make_fleet_tick(spec, "cpu", **kw)
        assert callable(tfleet.make_fleet_tick(spec, **kw))


# --- tests/test_fleet_v2.py's peer cases, in lockstep ---------------------------


@pytest.mark.parametrize("peer", [False, True])
def test_peer_avoidance_head_on(jax_fleets, peer):
    """Two r = 0.3 robots sent head-on along one line: with peers they keep
    their centers apart (contact at 0.6); without, they drive through
    each other."""
    fleets = _pair(jax_fleets, "head_on" if peer else "head_on_plain", HEAD_ON_PATHS)
    _, min_d = lockstep(fleets, HEAD_ON_STATES.copy(), 70)
    if peer:
        assert min_d > CONTACT, f"peers collided: min distance {min_d}"
    else:
        assert min_d < 0.4, f"control scenario too easy: {min_d}"


def test_peer_avoidance_single_robot_identity(jax_fleets):
    """A lone robot's commands are bit-identical with peer avoidance on
    (its own block is masked to the pad, the pad rows by n_real), in each
    package, and the two packages agree."""
    path = [np.array([[0.0, 0.0], [0.0, 2.0]])]
    start = np.array([[0.0, 0.0, np.pi / 2, 0.0]], np.float32)
    cmds = {}
    for name in ("lone", "lone_plain"):
        outs, _ = lockstep(_pair(jax_fleets, name, path), start.copy(), 6)
        cmds[name] = np.array([[o[k][0] for k in ("vx", "vy", "omega")] for o in outs])
    np.testing.assert_array_equal(cmds["lone"], cmds["lone_plain"])
    assert np.abs(cmds["lone"][:, 0]).max() > 0.1


def _replay(states, out, k):
    """The k-tick loop's trajectories, integrated from its commands."""
    s = states.astype(np.float64).copy()
    min_d = _min_distance(s)
    for t in range(k):
        vx, vy, om = (out[key][:, t] for key in ("vx", "vy", "omega"))
        c, sn = np.cos(s[:, 2]), np.sin(s[:, 2])
        s[:, 0] += DT * (vx * c - vy * sn)
        s[:, 1] += DT * (vx * sn + vy * c)
        s[:, 2] += DT * om
        min_d = min(min_d, _min_distance(s))
    return s, min_d


def test_peer_avoidance_k_ticks_on_device(jax_fleets):
    """The fleet-synchronous k-tick loop: two head-on robots, k = 50 in
    one call, peers re-derived from the loop's own states each tick; the
    integrated trajectories never come closer than contact."""
    fleets = _pair(jax_fleets, "head_on", HEAD_ON_PATHS)
    jout, out = (f.run_ticks_on_device(50, HEAD_ON_STATES, np.zeros((2, 3)),
                                       np.full((2, N_RAYS), 10.0), ANGLES)
                 for f in fleets)
    assert_rows_close(jout, out)
    s, min_d = _replay(HEAD_ON_STATES, out, 50)
    np.testing.assert_allclose(s[:, :3], out["final_states"][:, :3], rtol=1e-4,
                               atol=1e-4)
    assert min_d > CONTACT, f"peers collided inside the k-loop: {min_d}"


# --- 4 robots: head-on and crossing pairs, prediction, safety ------------------

PAIR_PATHS = [np.array([[0.0, 0.0], [4.0, 0.0]]), np.array([[4.0, 0.03], [0.0, 0.03]]),
              np.array([[2.0, 1.2], [2.0, 5.0]]), np.array([[0.3, 3.0], [4.0, 3.0]])]
# each robot 3.1 cm off its path: a rollout point on the path makes the
# Pallas forms' cancellation noise in d2 ~ 0 visible through the path
# cost's square root (test_torch_fleet.py keeps its robots off the path's
# grid for the same reason)
PAIR_STATES = np.array([[0.01, 0.031, 0.0, 0.0], [4.0, 0.061, np.pi, 0.0],
                        [2.031, 1.2, np.pi / 2, 0.0], [0.3, 3.031, 0.0, 0.0]],
                       np.float32)


def _pair_ranges():
    """Free space, but robot 2 has a post 0.9 m to its right and robot 3
    a NaN dropout (the safety gate sees the scan alone)."""
    ranges = np.full((4, N_RAYS), 10.0, np.float32)
    ranges[2, N_RAYS * 3 // 4 - 1: N_RAYS * 3 // 4 + 2] = 0.9
    ranges[3, 5] = np.nan
    return ranges


@pytest.mark.parametrize("predict", [False, True])
def test_pairs_lockstep(jax_fleets, predict):
    """Four robots with peers (and prediction) and the safety gate, 9 x 9
    samples: 25 single ticks in lockstep, then run_ticks_on_device k = 10
    from the start against JAX's, both without a collision."""
    name = "pairs_predict" if predict else "pairs"
    fleets = _pair(jax_fleets, name, PAIR_PATHS)
    outs, min_d = lockstep(fleets, PAIR_STATES.copy(), 25, _pair_ranges())
    assert min_d > CONTACT and outs[-1]["found"].all()
    for f in fleets:
        f.set_paths(PAIR_PATHS)
    jout, out = (f.run_ticks_on_device(10, PAIR_STATES, np.zeros((4, 3)),
                                       _pair_ranges(), ANGLES) for f in fleets)
    assert_rows_close(jout, out)
    assert _replay(PAIR_STATES, out, 10)[1] > CONTACT


def test_prediction_changes_the_choice(jax_fleets):
    """With prediction the peers' discs move within the rollout: on the
    same inputs, with both robots of the head-on pair already moving
    toward each other, the admissible sets differ from the frozen-disc
    fleet's."""
    outs = {}
    for name in ("pairs", "pairs_predict"):
        fleets = _pair(jax_fleets, name, PAIR_PATHS)
        states = PAIR_STATES.copy()
        states[1, 0] = 1.6
        vels = np.tile(np.array([0.8, 0.0, 0.0], np.float32), (4, 1))
        jout, outs[name] = (f.tick(states, vels, _pair_ranges(), ANGLES) for f in fleets)
        assert_rows_close(jout, outs[name])
    assert (outs["pairs"]["num_admissible"][:2]
            != outs["pairs_predict"]["num_admissible"][:2]).any()


# --- the peer k-tick loop per backend ------------------------------------------

K = 4


@pytest.mark.parametrize("backend,predict,kernel", [
    ("xla", False, "K1"), ("xla", True, "K3"), ("pallas", True, "K7"),
    ("pallas_vpu", False, "K6"), ("pallas_vpu", True, "K8")])
def test_peer_ticks_on_device_per_backend(jax_pallas_interpret, monkeypatch,
                                          backend, predict, kernel):
    """``make_fleet_ticks_on_device`` with peers under each backend: one
    sweep per tick through the backend's kernel (static without
    prediction, moving with it), against JAX's loop."""
    args = (4, True, predict, True, 4, 0.5)
    jf, tf = _fleet("jax", *args), _fleet("port", *args)
    for f in (jf, tf):
        f.set_paths(PAIR_PATHS)
        f._prepare_tick_inputs(PAIR_STATES, np.zeros((4, 3)), _pair_ranges(), ANGLES,
                               None)
    specs = [dataclasses.replace(f.spec, solver=dataclasses.replace(
        f.spec.solver, backend=backend)) for f in (jf, tf)]
    assert tfleet.fleet_spec_from_jax(specs[0]) == specs[1]
    jcarry, jouts, jfinal = jfleet.make_fleet_ticks_on_device(
        specs[0], K, peer_cfg=jf._peer_cfg, safety=True)(
        jf._paths, jf._cfg, jf._carry, jf._angles, jnp.asarray(jf._inputs), jf._safety)
    calls = []
    wrapper = kernels.SWEEP_KERNELS[kernel]
    monkeypatch.setattr(tsolver, wrapper.__name__,
                        lambda *a: calls.append(a[2].shape) or wrapper(*a))
    tcarry, touts, tfinal = tfleet.make_fleet_ticks_on_device(
        specs[1], K, "cpu", peer_cfg=tf._peer_cfg, safety=True)(
        tf._paths, tf._cfg, tf._carry, tf._angles, torch.from_numpy(tf._inputs),
        tf._safety)
    scan = tf.spec.solver.scan_size
    assert calls == [(4, scan + 4 * 9, 2)] * K  # scan bucket + 4 discs of 9
    F = tfleet.OUT_FIELDS
    pack = lambda outs, fin: dict(  # noqa: E731
        {f: np.asarray(outs)[:, :, i] for i, f in enumerate(F)},
        final_states=np.asarray(fin))
    assert_rows_close(pack(jouts, jfinal), pack(touts.numpy(), tfinal.numpy()))
    for jv, tv in zip(jcarry, tcarry):
        np.testing.assert_allclose(tv.numpy().astype(np.float64),
                                   np.asarray(jv).astype(np.float64), rtol=1e-5)
