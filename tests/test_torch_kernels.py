"""The port's fused min-distance sweep (ops/kernels.py) against the JAX
package's sweeps, on the CPU.

On the CPU the wrapper runs its plain PyTorch version, the same
operations the CUDA kernel rounds one by one (the kernel itself is held
bit-identical to it on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda.py``). Held here against:

- the XLA sweeps of the JAX DWA path (``_min_obstacle_dist_sq`` and the
  same form over the segment rows) at rel 1e-6 / atol 1e-7: both are the
  direct (p - o)^2 form in f32, so only an FMA contraction by XLA can
  move a value, by at most an ulp or two;
- the TPU kernel ``_fused_kernel_vpu`` run in Pallas interpret mode at
  rel 1e-4 / atol 1e-5, the tolerance ``tests/test_pallas_kernels.py``
  holds the direct form to. The TPU kernel's |o|^2 - 2 p.o + |p|^2
  expansion cancels with an absolute error of a few f32 ulps of
  |p|^2 + |o|^2, so the points stay within +-1.5 m here, where that error
  is below 1e-5.

The moving sweep (``fused_min_dist_sq_moving``, the port of TPU kernel K3)
is held against:

- the XLA form ``_min_obstacle_dist_sq_moving`` bit for bit: the same
  operations in the same order (tau = f32(t) * dt, o + v * tau, then the
  direct square), and XLA contracts none of them on the CPU;
- the TPU kernel ``_fused_kernel_vpu_moving`` in Pallas interpret mode at
  rel 1e-4 / atol 1e-5 over +-1.5 m and +-1 m/s: its 7-feature expansion
  cancels like the static expansion, plus the |v|^2 tau^2 term;
- the static sweep, bit for bit, at zero velocity;
- per-robot calls, bit for bit, when robots go in one batch.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kompass_core_tpu.ops.pallas_kernels import fused_min_dist_sq as jax_fused
from kompass_core_tpu.ops.solver import (
    _min_obstacle_dist_sq,
    _min_obstacle_dist_sq_moving,
)
from kompass_core_tpu_torch.ops import kernels
from kompass_core_tpu_torch.ops.kernels import (
    fused_min_dist_sq,
    fused_min_dist_sq_moving,
    fused_min_dist_sq_reference,
)

torch.set_num_threads(2)


def _inputs(seed, S=40, T=12, O=64, G=48, span=5.0, obs_span=8.0):
    rng = np.random.default_rng(seed)
    return dict(
        px=rng.uniform(-span, span, (S, T)).astype(np.float32),
        py=rng.uniform(-span, span, (S, T)).astype(np.float32),
        obs=rng.uniform(-obs_span, obs_span, (O, 2)).astype(np.float32),
        sx=rng.uniform(-span, span, G).astype(np.float32),
        sy=rng.uniform(-span, span, G).astype(np.float32),
    )


def _port(d, active):
    return fused_min_dist_sq(
        torch.from_numpy(d["px"]), torch.from_numpy(d["py"]),
        torch.from_numpy(d["obs"]), torch.from_numpy(d["sx"]),
        torch.from_numpy(d["sy"]), torch.tensor(active, dtype=torch.int32),
    )


def _jax_xla(d, active):
    T = d["px"].shape[1]
    mask = jnp.arange(T) < active
    px, py = jnp.asarray(d["px"]), jnp.asarray(d["py"])
    d2o = _min_obstacle_dist_sq(px, py, jnp.asarray(d["obs"]), mask)
    seg = jnp.stack([jnp.asarray(d["sx"]), jnp.asarray(d["sy"])], axis=1)
    d2s = _min_obstacle_dist_sq(px, py, seg, mask)
    return np.asarray(d2o), np.asarray(d2s)


@pytest.mark.parametrize("seed,active", [(0, 12), (1, 9), (2, 2)])
def test_plain_sweep_matches_jax_xla_sweeps(seed, active):
    d = _inputs(seed)
    d2o, d2s = _port(d, active)
    ref_o, ref_s = _jax_xla(d, active)
    for got, ref in ((d2o.numpy(), ref_o), (d2s.numpy(), ref_s)):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
        # masked steps are +inf in both, active ones finite
        assert np.isinf(got[:, active:]).all()
        assert np.isfinite(got[:, :active]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_sweep_matches_tpu_kernel_interpret(seed):
    d = _inputs(seed, span=1.5, obs_span=1.5)
    active = 9
    d2o, d2s = _port(d, active)
    T = d["px"].shape[1]
    ref_o, ref_s = jax_fused(
        jnp.asarray(d["px"]), jnp.asarray(d["py"]), jnp.asarray(d["obs"]),
        jnp.asarray(d["sx"]), jnp.asarray(d["sy"]), jnp.arange(T) < active,
        variant="vpu", interpret=True,
    )
    for got, ref in ((d2o.numpy(), ref_o), (d2s.numpy(), ref_s)):
        np.testing.assert_allclose(
            got[:, :active], np.asarray(ref)[:, :active], rtol=1e-4, atol=1e-5
        )
        assert np.isinf(np.asarray(ref)[:, active:]).all()
        assert np.isinf(got[:, active:]).all()


def test_point_on_obstacle_is_exactly_zero():
    """p == o gives d2 == 0 exactly in the direct form, never negative
    (the expansion form needs a clamp there)."""
    pt = np.float32(3.7)
    d = dict(
        px=np.full((1, 3), pt, np.float32), py=np.full((1, 3), -pt, np.float32),
        obs=np.array([[pt, -pt], [1e8, 1e8]], np.float32),
        sx=np.array([pt], np.float32), sy=np.array([-pt], np.float32),
    )
    d2o, d2s = _port(d, 3)
    assert (d2o.numpy() == 0.0).all() and (d2s.numpy() == 0.0).all()


def test_all_pad_rows_stay_finite_and_huge():
    """With every obstacle row a 1e8 pad the field is finite (~1e16) at
    the active steps, so the obs_count == 0 gate, not an inf, keeps the
    obstacle cost out, exactly as in the JAX package."""
    d = _inputs(3, O=256)
    d["obs"][:] = 1e8
    d2o, _ = _port(d, 7)
    ref_o, _ = _jax_xla(d, 7)
    got = d2o.numpy()
    assert np.isfinite(got[:, :7]).all() and (got[:, :7] > 1e15).all()
    np.testing.assert_allclose(got, ref_o, rtol=1e-6)


def test_plain_version_slabs_agree_with_one_broadcast(monkeypatch):
    """Splitting the broadcast over rows of S does not change a value."""
    d = _inputs(4, S=33, T=7, O=40, G=24)
    whole = _port(d, 7)
    monkeypatch.setattr(kernels, "_SLAB_ELEMS", 7 * 40 * 5)
    slabs = _port(d, 7)
    for a, b in zip(whole, slabs):
        assert torch.equal(a, b)


def test_nan_propagates_like_amin():
    d = _inputs(5, S=4, T=3, O=8, G=8)
    d["obs"][2, 0] = np.nan
    d2o, d2s = _port(d, 3)
    assert np.isnan(d2o.numpy()).all()
    assert np.isfinite(d2s.numpy()).all()


def test_cpu_run_does_not_count_a_launch():
    before = fused_min_dist_sq.launches
    _port(_inputs(6, S=4, T=3, O=8, G=8), 3)
    assert fused_min_dist_sq.launches == before


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(px=lambda t: t.double()), TypeError),
        (dict(active=lambda t: t.long()), TypeError),
        (dict(obs=lambda t: t[:, :1].contiguous()), ValueError),
        (dict(obs=lambda t: t[:0]), ValueError),
        (dict(sx=lambda t: t[:-1]), ValueError),
        (dict(px=lambda t: t.T), ValueError),
        (dict(obs=lambda t: t.T.contiguous().T), ValueError),
        (dict(py=lambda t: t.to("meta")), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    d = _inputs(7, S=6, T=6, O=8, G=8)
    args = dict(
        px=torch.from_numpy(d["px"]), py=torch.from_numpy(d["py"]),
        obs=torch.from_numpy(d["obs"]), sx=torch.from_numpy(d["sx"]),
        sy=torch.from_numpy(d["sy"]), active=torch.tensor(6, dtype=torch.int32),
    )
    for k, fn in change.items():
        args[k] = fn(args[k])
    with pytest.raises(error):
        fused_min_dist_sq(
            args["px"], args["py"], args["obs"], args["sx"], args["sy"],
            args["active"],
        )


def test_build_without_nvcc_raises_and_never_falls_back(monkeypatch, tmp_path):
    """A missing compiler is an error with a message, not a silent switch
    to the plain version."""
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build_library()
    assert not any(tmp_path.rglob("*.so"))


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: simulated compiler fault' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    with pytest.raises(RuntimeError, match="simulated compiler fault"):
        kernels.build_library()


def test_library_path_is_keyed_by_the_sources():
    path = kernels.library_path()
    assert path.parent.parent == kernels.BUILD_DIR
    assert path == kernels.library_path()


# --- the moving sweep (TPU kernel K3's port) and the robot axis --------------


def _velocities(seed, O, vmax=1.0):
    rng = np.random.default_rng(seed + 1000)
    return rng.uniform(-vmax, vmax, (O, 2)).astype(np.float32)


def _port_moving(d, vel, dt, active):
    return fused_min_dist_sq_moving(
        torch.from_numpy(d["px"]), torch.from_numpy(d["py"]),
        torch.from_numpy(d["obs"]), torch.from_numpy(vel),
        torch.tensor(dt, dtype=torch.float32), torch.from_numpy(d["sx"]),
        torch.from_numpy(d["sy"]), torch.tensor(active, dtype=torch.int32),
    )


@pytest.mark.parametrize("seed,active", [(0, 12), (1, 9), (2, 2)])
def test_moving_sweep_matches_jax_xla_moving_sweep_exactly(seed, active):
    d = _inputs(seed)
    vel = _velocities(seed, d["obs"].shape[0])
    d2o, d2s = _port_moving(d, vel, 0.1, active)
    T = d["px"].shape[1]
    ref = _min_obstacle_dist_sq_moving(
        jnp.asarray(d["px"]), jnp.asarray(d["py"]), jnp.asarray(d["obs"]),
        jnp.asarray(vel), jnp.float32(0.1), jnp.arange(T) < active,
    )
    np.testing.assert_array_equal(d2o.numpy(), np.asarray(ref))
    # the segment rows never move
    np.testing.assert_array_equal(d2s.numpy(), _port(d, active)[1].numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_moving_sweep_matches_tpu_kernel_interpret(seed):
    d = _inputs(seed, span=1.5, obs_span=1.5)
    vel = _velocities(seed, d["obs"].shape[0])
    active = 9
    T = d["px"].shape[1]
    d2o, d2s = _port_moving(d, vel, 0.1, active)
    ref_o, ref_s = jax_fused(
        jnp.asarray(d["px"]), jnp.asarray(d["py"]), jnp.asarray(d["obs"]),
        jnp.asarray(d["sx"]), jnp.asarray(d["sy"]), jnp.arange(T) < active,
        variant="vpu", obs_vel=jnp.asarray(vel), time_step=jnp.float32(0.1),
        interpret=True,
    )
    for got, ref in ((d2o.numpy(), ref_o), (d2s.numpy(), ref_s)):
        np.testing.assert_allclose(
            got[:, :active], np.asarray(ref)[:, :active], rtol=1e-4, atol=1e-5
        )
        assert np.isinf(np.asarray(ref)[:, active:]).all()
        assert np.isinf(got[:, active:]).all()


@pytest.mark.parametrize("dt", [0.1, 0.05])
def test_zero_velocity_equals_the_static_sweep_bit_for_bit(dt):
    d = _inputs(8)
    d["obs"][:5] = 1e8  # pad rows
    d["obs"][5, 0] = -0.0
    static = _port(d, 10)
    moving = _port_moving(d, np.zeros_like(d["obs"]), dt, 10)
    for a, b in zip(static, moving):
        assert torch.equal(a, b)


def test_moving_pad_rows_with_zero_velocity_never_win():
    d = _inputs(9, O=8)
    vel = _velocities(9, 8)
    d["obs"][4:] = 1e8
    vel[4:] = 0.0
    with_pads = _port_moving(d, vel, 0.1, 12)
    d4 = dict(d, obs=d["obs"][:4].copy())
    without = _port_moving(d4, vel[:4].copy(), 0.1, 12)
    for a, b in zip(with_pads, without):
        assert torch.equal(a, b)


def test_moving_nan_propagates_like_amin():
    d = _inputs(10, S=4, T=3, O=8, G=8)
    vel = _velocities(10, 8)
    vel[3, 1] = np.nan
    d2o, d2s = _port_moving(d, vel, 0.1, 3)
    # tau = 0 at t = 0 still gives NaN * 0 = NaN
    assert np.isnan(d2o.numpy()).all()
    assert np.isfinite(d2s.numpy()).all()


def _batch(seeds, S=24, T=9, O=40, G=32):
    ds = [_inputs(s, S=S, T=T, O=O, G=G) for s in seeds]
    vels = [_velocities(s, O) for s in seeds]
    stack = {k: torch.from_numpy(np.stack([d[k] for d in ds])) for k in ds[0]}
    return ds, vels, stack, torch.from_numpy(np.stack(vels))


@pytest.mark.parametrize("moving", [False, True])
def test_batched_sweep_equals_per_robot_calls_bit_for_bit(moving):
    """Three robots with their own rows, horizon and step in one call
    give each robot's own call's values exactly."""
    ds, vels, st, vel_b = _batch([11, 12, 13])
    active = [9, 4, 2]
    dts = [0.1, 0.05, 0.2]
    ap = torch.tensor(active, dtype=torch.int32)
    if moving:
        got = fused_min_dist_sq_moving(
            st["px"], st["py"], st["obs"], vel_b, torch.tensor(dts), st["sx"],
            st["sy"], ap,
        )
    else:
        got = fused_min_dist_sq(st["px"], st["py"], st["obs"], st["sx"], st["sy"], ap)
    for b, d in enumerate(ds):
        want = (_port_moving(d, vels[b], dts[b], active[b]) if moving
                else _port(d, active[b]))
        for g, w in zip(got, want):
            assert g.shape == (3,) + w.shape
            assert torch.equal(g[b], w)


def test_batched_plain_version_slabs_span_robots(monkeypatch):
    """Slabs that hold several whole robots, or part of one, give the
    values of one broadcast."""
    _, _, st, vel_b = _batch([14, 15, 16, 17], S=10, T=5, O=12, G=12)
    args = (st["px"], st["py"], st["obs"], st["sx"], st["sy"],
            torch.tensor([5, 3, 5, 1], dtype=torch.int32), vel_b,
            torch.tensor([0.1, 0.1, 0.2, 0.3]))
    whole = fused_min_dist_sq_reference(*args)
    for elems in (2 * 10 * 5 * 12, 3 * 5 * 12):
        monkeypatch.setattr(kernels, "_SLAB_ELEMS", elems)
        for a, b in zip(whole, fused_min_dist_sq_reference(*args)):
            assert torch.equal(a, b)


def test_cpu_moving_run_does_not_count_a_launch():
    before = (fused_min_dist_sq.launches, fused_min_dist_sq_moving.launches)
    d = _inputs(6, S=4, T=3, O=8, G=8)
    _port_moving(d, _velocities(6, 8), 0.1, 3)
    assert (fused_min_dist_sq.launches, fused_min_dist_sq_moving.launches) == before


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(vel=lambda t: t[:-1].contiguous()), ValueError),
        (dict(vel=lambda t: t.double()), TypeError),
        (dict(dt=lambda t: t.reshape(1).repeat(2)), TypeError),
        (dict(active=lambda t: t.reshape(1).repeat(2)), TypeError),
        (dict(vel=lambda t: t.T.contiguous().T), ValueError),
    ],
)
def test_moving_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    d = _inputs(7, S=6, T=6, O=8, G=8)
    args = dict(
        px=torch.from_numpy(d["px"]), py=torch.from_numpy(d["py"]),
        obs=torch.from_numpy(d["obs"]), vel=torch.from_numpy(_velocities(7, 8)),
        dt=torch.tensor(0.1), sx=torch.from_numpy(d["sx"]),
        sy=torch.from_numpy(d["sy"]), active=torch.tensor(6, dtype=torch.int32),
    )
    for k, fn in change.items():
        args[k] = fn(args[k])
    with pytest.raises(error):
        fused_min_dist_sq_moving(*args.values())


def test_batched_wrapper_rejects_mismatched_robot_axes():
    _, _, st, vel_b = _batch([18, 19])
    ap = torch.tensor([9, 9], dtype=torch.int32)
    with pytest.raises(ValueError, match="per robot"):
        fused_min_dist_sq(st["px"], st["py"], st["obs"][:1], st["sx"], st["sy"], ap)
    with pytest.raises(ValueError, match=r"\[B\]"):
        fused_min_dist_sq(st["px"], st["py"], st["obs"], st["sx"], st["sy"], ap[:1])
    with pytest.raises(ValueError, match="dt"):
        fused_min_dist_sq_moving(st["px"], st["py"], st["obs"], vel_b,
                                 torch.tensor([0.1]), st["sx"], st["sy"], ap)
