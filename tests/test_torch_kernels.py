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

The expanded sweeps (``fused_min_dist_sq_expanded``, the port of TPU
kernel K2, and ``min_dist_sq_expanded``, K4) are held against the TPU
kernels ``_fused_kernel_mxu`` in interpret mode and
``min_obstacle_dist_sq_mxu``'s interpret form at rel 2e-4 / atol 1e-4
(see ``EXPANDED_RTOL``), single and batched, at the JAX package's
coordinates.
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


# --- the expanded forms: K2 (both sweeps) and K4 (one sweep) -----------------

from kompass_core_tpu.ops.pallas_kernels import min_obstacle_dist_sq_mxu
from kompass_core_tpu_torch.ops.kernels import (
    fused_min_dist_sq_expanded,
    fused_min_dist_sq_expanded_reference,
    min_dist_sq_expanded,
    min_dist_sq_expanded_reference,
)

# Not bit for bit: XLA's CPU dot computes the cross term as
# fma(oy, py, ox * px), and K2's interpret form also fuses |p|^2 into an
# FMA where K4's does not, while the port rounds every operation on its
# own, as the kernels are specified (15-35% of the values differ by an
# ulp or two of |p|^2 + |o|^2). Held at the tolerance the JAX package's
# kernel bench holds these kernels to (benchmark/kernel_bench.py:111-113).
EXPANDED_RTOL, EXPANDED_ATOL = 2e-4, 1e-4


def _expanded(d, active):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    ap = torch.tensor(active, dtype=torch.int32)
    return (fused_min_dist_sq_expanded(t["px"], t["py"], t["obs"], t["sx"],
                                       t["sy"], ap),
            min_dist_sq_expanded(t["px"], t["py"], t["obs"], ap))


@pytest.mark.parametrize("seed,active", [(0, 12), (1, 9), (2, 2)])
def test_expanded_sweeps_match_tpu_kernels_interpret(seed, active):
    """K2's plain version against ``_fused_kernel_mxu`` and K4's against
    ``min_obstacle_dist_sq_mxu``'s interpret form, at the JAX package's
    coordinates (within 10 m of the origin)."""
    d = _inputs(seed, span=5.0, obs_span=8.0)
    (k2_obs, k2_seg), k4 = _expanded(d, active)
    T = d["px"].shape[1]
    j = {k: jnp.asarray(v) for k, v in d.items()}
    mask = jnp.arange(T) < active
    ref_o, ref_s = jax_fused(j["px"], j["py"], j["obs"], j["sx"], j["sy"],
                             mask, variant="mxu", interpret=True)
    ref_4 = min_obstacle_dist_sq_mxu(j["px"], j["py"], j["obs"], mask,
                                     interpret=True)
    for got, ref in ((k2_obs, ref_o), (k2_seg, ref_s), (k4, ref_4)):
        got, ref = got.numpy(), np.asarray(ref)
        np.testing.assert_allclose(got[:, :active], ref[:, :active],
                                   rtol=EXPANDED_RTOL, atol=EXPANDED_ATOL)
        assert np.isinf(got[:, active:]).all() and np.isinf(ref[:, active:]).all()
        assert (got[:, :active] >= 0).all()
    # K4 over the obstacle rows is K2's obstacle field, value for value
    assert torch.equal(k4, k2_obs)


def test_expanded_sweeps_are_the_expansion_of_the_direct_form():
    """At the JAX package's coordinates the expanded fields stay within
    a few ulps of |p|^2 + |o|^2 of the direct form's (K1)."""
    d = _inputs(20, S=30, T=10, O=40, G=40, span=10.0, obs_span=10.0)
    (k2_obs, k2_seg), _ = _expanded(d, 10)
    d2o, d2s = _port(d, 10)
    for got, ref in ((k2_obs, d2o), (k2_seg, d2s)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4)


def test_expanded_point_on_a_row_clamps_at_zero():
    """p == o: the expansion may round below zero; the clamp gives >= 0,
    and a NaN row still propagates like amin."""
    pt = np.float32(3.7)
    d = dict(
        px=np.full((1, 3), pt, np.float32), py=np.full((1, 3), -pt, np.float32),
        obs=np.array([[pt, -pt], [1e8, 1e8]], np.float32),
        sx=np.array([pt, np.nan], np.float32), sy=np.array([-pt, 0.0], np.float32),
    )
    (d2o, d2s), k4 = _expanded(d, 3)
    assert (d2o.numpy() >= 0).all() and (d2o.numpy() < 1e-5).all()
    assert torch.equal(d2o, k4)
    assert np.isnan(d2s.numpy()).all()


def test_expanded_pad_rows_stay_finite_and_never_win():
    d = _inputs(21, O=300)
    (with_pads, _), k4 = _expanded(d, 12)
    d["obs"][200:] = 1e8
    (padded, _), _ = _expanded(d, 12)
    (without, _), _ = _expanded(dict(d, obs=d["obs"][:200].copy()), 12)
    assert torch.equal(padded, without)
    d["obs"][:] = 1e8
    (all_pads, _), _ = _expanded(d, 12)
    assert np.isfinite(all_pads.numpy()).all() and (all_pads.numpy() > 1e15).all()


def test_expanded_batched_equals_per_robot_calls_bit_for_bit():
    """Three robots in one call give each robot's own call's values
    exactly, and each robot's rows hold against the TPU kernels in
    interpret mode."""
    ds, _, st, _ = _batch([31, 32, 33])
    active = [9, 4, 2]
    ap = torch.tensor(active, dtype=torch.int32)
    k2 = fused_min_dist_sq_expanded(st["px"], st["py"], st["obs"], st["sx"],
                                    st["sy"], ap)
    k4 = min_dist_sq_expanded(st["px"], st["py"], st["obs"], ap)
    for b, d in enumerate(ds):
        (one_o, one_s), one_4 = _expanded(d, active[b])
        assert torch.equal(k2[0][b], one_o) and torch.equal(k2[1][b], one_s)
        assert torch.equal(k4[b], one_4)
        j = {k: jnp.asarray(v) for k, v in d.items()}
        mask = jnp.arange(d["px"].shape[1]) < active[b]
        ref_o, ref_s = jax_fused(j["px"], j["py"], j["obs"], j["sx"], j["sy"],
                                 mask, variant="mxu", interpret=True)
        ref_4 = min_obstacle_dist_sq_mxu(j["px"], j["py"], j["obs"], mask,
                                         interpret=True)
        for got, ref in ((k2[0][b], ref_o), (k2[1][b], ref_s), (k4[b], ref_4)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=EXPANDED_RTOL, atol=EXPANDED_ATOL)


def test_expanded_plain_version_slabs_agree_with_one_broadcast(monkeypatch):
    d = _inputs(22, S=33, T=7, O=40, G=24)
    whole = _expanded(d, 7)
    monkeypatch.setattr(kernels, "_SLAB_ELEMS", 7 * 40 * 5)
    slabs = _expanded(d, 7)
    for a, b in zip((*whole[0], whole[1]), (*slabs[0], slabs[1])):
        assert torch.equal(a, b)


def test_cpu_expanded_runs_do_not_count_a_launch():
    before = (fused_min_dist_sq_expanded.launches, min_dist_sq_expanded.launches)
    _expanded(_inputs(23, S=4, T=3, O=8, G=8), 3)
    assert (fused_min_dist_sq_expanded.launches,
            min_dist_sq_expanded.launches) == before


def test_expanded_wrappers_reject_what_the_kernels_do_not_take():
    d = _inputs(24, S=6, T=6, O=8, G=8)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    ap = torch.tensor(6, dtype=torch.int32)
    with pytest.raises(ValueError, match="O, 2"):
        min_dist_sq_expanded(t["px"], t["py"], t["obs"][:, :1].contiguous(), ap)
    with pytest.raises(TypeError):
        min_dist_sq_expanded(t["px"], t["py"], t["obs"], ap.long())
    with pytest.raises(ValueError, match="G"):
        fused_min_dist_sq_expanded_reference(t["px"], t["py"], t["obs"],
                                             t["sx"][:-1], t["sy"], ap)
    assert torch.equal(min_dist_sq_expanded_reference(t["px"], t["py"], t["obs"], ap),
                       min_dist_sq_expanded(t["px"], t["py"], t["obs"], ap))
