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
    # the interpret forms as XLA's CPU backend contracts them, bit for bit
    j2 = jax.jit(lambda *a: jax_fused(*a, mask, variant="mxu", interpret=True))
    j4 = jax.jit(lambda *a: min_obstacle_dist_sq_mxu(*a, mask, interpret=True))
    args = [torch.from_numpy(d[k]) for k in ("px", "py", "obs", "sx", "sy")]
    for form, want in (("expanded", j2(j["px"], j["py"], j["obs"], j["sx"], j["sy"])),
                       ("single", (j4(j["px"], j["py"], j["obs"]),))):
        for twin, ref in zip(xla_cpu_fields(form, *args, active), want):
            np.testing.assert_array_equal(twin.numpy(), np.asarray(ref))


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


# --- the TPU kernels' own forms: K6 (broadcast), K7 and K8 (7 features) -------

import fractions
import os
import subprocess
import sys

import jax

from kompass_core_tpu_torch.ops.kernels import (
    _fma,
    _fma_rn,
    fused_min_dist_sq_broadcast,
    fused_min_dist_sq_broadcast_reference,
    fused_min_dist_sq_moving_broadcast,
    fused_min_dist_sq_moving_expanded,
    fused_min_dist_sq_moving_expanded_reference,
)

# The JAX side runs under jax.jit, as the solver does: XLA's CPU backend
# then fuses the kernels' multiply-adds into FMAs (probed operation by
# operation; ``xla_cpu_fields`` below is what it computes). K7's chosen
# order is that one, so its obstacle field is held bit for bit. K6 and K8
# round every operation on its own, as the TPU's vector unit does and the
# card kernels do, so their plain versions are held at the expanded
# forms' tolerance (an ulp or two of |p|^2 + |o|^2), and their forms bit
# for bit through ``xla_cpu_fields``, the same functions with XLA's
# contractions.
#
# Compiled for a CPU without FMA instructions (NO_FMA), XLA rounds every
# multiply and add of the kernels on its own, as the TPU's vector unit
# does; only its dot, a library routine, still runs the feature-order FMA
# chain that K7 chose. There the JAX kernels and the port's production
# forms must agree bit for bit. XLA reads the flag when the backend
# starts, so those JAX fields come from a fresh process
# (``jax_without_fma``).

NO_FMA = "--xla_cpu_max_isa=SSE4_2"


def jax_without_fma(module, path):
    """``module.jax_fields_without_fma()`` (a dict of arrays) computed in
    a fresh process whose XLA emits no FMA, saved to and read from
    ``path``."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {NO_FMA}".strip(),
               PYTHONPATH=os.pathsep.join(
                   [tests, os.path.dirname(tests), os.environ.get("PYTHONPATH", "")]))
    code = (f"import numpy, {module} as m; "
            f"numpy.savez({str(path)!r}, **m.jax_fields_without_fma())")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=600, capture_output=True)
    with np.load(path) as fields:
        return dict(fields)


def _fma_t(a, b, c):
    return _fma_rn(*(torch.as_tensor(v, dtype=torch.float32) for v in (a, b, c)))


def xla_cpu_fields(form, px, py, obs, sx, sy, active, vel=None, dt=None):
    """One robot's (d2_obs, d2_seg) of the JAX sweep of ``form`` ("direct":
    the XLA sweeps; "expanded": the mxu kernels; "single": the interpret
    form of ``min_obstacle_dist_sq_mxu``, K4's, whose |p|^2 is a sum over
    the point rows; "broadcast": the vpu kernels) as XLA's CPU backend
    compiles it under ``jax.jit``: every
    multiply feeding an add fused (``_fma_rn``), except |v|^2 and, in the
    vpu kernel's left fold, f1 tau^2 (added to f0 * 1, which needs no
    rounding of its own). With ``vel`` the obstacle rows move (K3's, K7's
    and K8's functions). Float32 tensors [S, T], [O, 2], [G]; returns
    [S, T] each, +inf at t >= active."""
    T = px.shape[-1]
    X, Y = px[..., None], py[..., None]

    def static(ox, oy):
        if form == "direct":
            dx, dy = X - ox, Y - oy
            return _fma_rn(dx, dx, dy * dy).amin(-1)
        on = _fma_rn(ox, ox, oy * oy)
        if form in ("expanded", "single"):
            d = on - 2.0 * _fma_rn(oy, Y, ox * X)
        else:
            d = _fma_rn(-2.0 * Y, oy, _fma_rn(-2.0 * X, ox, on))
        return d.amin(-1)

    ox, oy = obs[:, 0], obs[:, 1]
    if vel is None:
        d2o = static(ox, oy)
    else:
        vx, vy = vel[:, 0], vel[:, 1]
        tau = (torch.arange(T, dtype=torch.float32) * dt)[:, None]  # [T, 1]
        if form == "direct":
            dx = X - _fma_rn(vx, tau, ox)
            dy = Y - _fma_rn(vy, tau, oy)
            d2o = _fma_rn(dx, dx, dy * dy).amin(-1)
        else:
            f0 = _fma_rn(ox, ox, oy * oy)
            f1 = vx * vx + vy * vy
            f2 = 2.0 * _fma_rn(vx, ox, vy * oy)
            if form == "expanded":
                c = _fma_rn(f2, tau, _fma_rn(f1, tau * tau, f0))
            else:
                c = _fma_rn(f2, tau, f0 + f1 * (tau * tau))
            d = _fma_rn(-2.0 * ox, X, c)
            d = _fma_rn(-2.0 * oy, Y, d)
            d = _fma_rn(-2.0 * vx, (tau[:, 0] * px)[..., None], d)
            d2o = _fma_rn(-2.0 * vy, (tau[:, 0] * py)[..., None], d).amin(-1)
    fields = [d2o, static(sx, sy)]
    if form != "direct":
        pn = (_fma_rn(py, py, px * px) if form == "single"
              else _fma_rn(px, px, py * py))
        fields = [torch.where(f + pn < 0.0, 0.0, f + pn) for f in fields]
    mask = (torch.arange(T) < active)[None, :]
    return tuple(torch.where(mask, f, torch.inf) for f in fields)


def _jax_tpu_form(d, active, variant, vel=None, dt=0.1):
    """The Pallas kernel of ``variant`` in interpret mode, under jax.jit."""
    T = d["px"].shape[1]
    mask = jnp.arange(T) < active
    kw = {} if vel is None else dict(obs_vel=jnp.asarray(vel),
                                     time_step=jnp.float32(dt))
    fn = jax.jit(lambda px, py, obs, sx, sy: jax_fused(
        px, py, obs, sx, sy, mask, variant=variant, interpret=True, **kw))
    return tuple(np.asarray(a) for a in fn(
        *(jnp.asarray(d[k]) for k in ("px", "py", "obs", "sx", "sy"))))


def _tpu_form_port(name, d, active, vel=None, dt=0.1):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    ap = torch.tensor(active, dtype=torch.int32)
    if name == "K6":
        return fused_min_dist_sq_broadcast(t["px"], t["py"], t["obs"], t["sx"],
                                           t["sy"], ap)
    fn = (fused_min_dist_sq_moving_expanded if name == "K7"
          else fused_min_dist_sq_moving_broadcast)
    return fn(t["px"], t["py"], t["obs"], torch.from_numpy(vel),
              torch.tensor(dt, dtype=torch.float32), t["sx"], t["sy"], ap)


TPU_FORMS = {"K6": ("vpu", "broadcast", False), "K7": ("mxu", "expanded", True),
             "K8": ("vpu", "broadcast", True)}
TPU_FORM_CASES = [(0, 12), (1, 9), (2, 2)]  # (seed, active steps)


def _tpu_form_case(name, seed):
    d = _inputs(seed, S=32, T=12, O=300, G=200, span=12.0, obs_span=12.0)
    vel = _velocities(seed, 300, vmax=1.5) if TPU_FORMS[name][2] else None
    return d, vel


def jax_fields_without_fma():
    """Each TPU-form case's (d2_obs, d2_seg) of its JAX kernel, for
    ``jax_without_fma``."""
    fields = {}
    for name, (variant, _, _) in TPU_FORMS.items():
        for seed, active in TPU_FORM_CASES:
            d, vel = _tpu_form_case(name, seed)
            for i, f in enumerate(_jax_tpu_form(d, active, variant, vel)):
                fields[f"{name}/{seed}/{i}"] = f
    return fields


@pytest.fixture(scope="module")
def tpu_forms_without_fma(tmp_path_factory):
    return jax_without_fma("test_torch_kernels",
                           tmp_path_factory.mktemp("no_fma") / "forms.npz")


@pytest.mark.parametrize("name", sorted(TPU_FORMS))
@pytest.mark.parametrize("seed,active", TPU_FORM_CASES)
def test_tpu_form_plain_versions_match_interpret_kernels(
        tpu_forms_without_fma, name, seed, active):
    """K6, K7 and K8 against their Pallas kernels in interpret mode, at
    the JAX package's coordinates (within 12 m of the origin, obstacles
    at up to 1.5 m/s): every field at the expanded forms' tolerance;
    every field of the XLA-contracted form (``xla_cpu_fields``) bit for
    bit; and every field bit for bit against the kernel compiled without
    FMA (``NO_FMA``), each of its operations rounded on its own."""
    variant, form, moving = TPU_FORMS[name]
    d, vel = _tpu_form_case(name, seed)
    got = _tpu_form_port(name, d, active, vel)
    ref = _jax_tpu_form(d, active, variant, vel)
    twin = xla_cpu_fields(form, *(torch.from_numpy(d[k]) for k in
                                  ("px", "py", "obs", "sx", "sy")), active,
                          None if vel is None else torch.from_numpy(vel), 0.1)
    for i, (g, r, w) in enumerate(zip(got, ref, twin)):
        g = g.numpy()
        np.testing.assert_array_equal(w.numpy(), r)
        assert np.isinf(g[:, active:]).all() and np.isinf(r[:, active:]).all()
        np.testing.assert_allclose(g[:, :active], r[:, :active],
                                   rtol=EXPANDED_RTOL, atol=EXPANDED_ATOL)
        assert (g[:, :active] >= 0).all()
        np.testing.assert_array_equal(
            g, tpu_forms_without_fma[f"{name}/{seed}/{i}"], err_msg=f"field {i}")


@pytest.mark.parametrize("seed", [3, 4])
def test_tpu_form_segment_fields_are_the_static_forms(seed):
    """K7's segment field is K2's and K8's is K6's, bit for bit; with
    zero velocity K8's obstacle field is K6's too (the velocity terms add
    +-0), and K7's is within the expanded tolerance of K2's (another
    summation order)."""
    d = _inputs(seed, S=20, T=9, O=100, G=60, span=10.0, obs_span=10.0)
    vel = _velocities(seed, 100, vmax=1.5)
    k6 = _tpu_form_port("K6", d, 7)
    (k2, k2_seg), _ = _expanded(d, 7)
    k7 = _tpu_form_port("K7", d, 7, vel)
    k8 = _tpu_form_port("K8", d, 7, vel)
    assert torch.equal(k7[1], k2_seg) and torch.equal(k8[1], k6[1])
    zero = np.zeros_like(vel)
    k8z = _tpu_form_port("K8", d, 7, zero)
    assert torch.equal(k8z[0], k6[0]) and torch.equal(k8z[1], k6[1])
    k7z = _tpu_form_port("K7", d, 7, zero)
    np.testing.assert_allclose(k7z[0].numpy(), k2.numpy(), rtol=EXPANDED_RTOL,
                               atol=EXPANDED_ATOL)


@pytest.mark.parametrize("name", sorted(TPU_FORMS))
def test_tpu_form_pad_rows_never_win_and_nan_propagates(name):
    """Pad rows at 1e8 (zero velocity) change no value; all-pad rows stay
    finite and huge; a NaN row makes the field NaN, like amin."""
    moving = TPU_FORMS[name][2]
    d = _inputs(25, S=8, T=6, O=40, G=16, span=10.0, obs_span=10.0)
    vel = _velocities(25, 40, vmax=1.5)
    d["obs"][24:], vel[24:] = 1e8, 0.0
    padded = _tpu_form_port(name, d, 6, vel if moving else None)
    short = dict(d, obs=d["obs"][:24].copy())
    without = _tpu_form_port(name, short, 6, vel[:24].copy() if moving else None)
    assert torch.equal(padded[0], without[0])
    pads = dict(d, obs=np.full_like(d["obs"], 1e8))
    all_pads = _tpu_form_port(name, pads, 6, np.zeros_like(vel) if moving else None)
    assert np.isfinite(all_pads[0].numpy()).all() and (all_pads[0].numpy() > 1e15).all()
    d["obs"][3, 1] = np.nan
    nan_rows = _tpu_form_port(name, d, 6, vel if moving else None)
    assert np.isnan(nan_rows[0].numpy()).all()
    assert np.isfinite(nan_rows[1].numpy()).all()


@pytest.mark.parametrize("name", sorted(TPU_FORMS))
def test_tpu_form_batched_equals_per_robot_calls_and_slabs(name, monkeypatch):
    """Three robots in one call give each robot's own call's values
    exactly, and slabs of any size give one broadcast's values."""
    moving = TPU_FORMS[name][2]
    ds, vels, st, vel_b = _batch([41, 42, 43])
    active, dts = [9, 4, 2], [0.1, 0.05, 0.2]
    ap = torch.tensor(active, dtype=torch.int32)

    def batch():
        if name == "K6":
            return fused_min_dist_sq_broadcast(st["px"], st["py"], st["obs"],
                                               st["sx"], st["sy"], ap)
        fn = (fused_min_dist_sq_moving_expanded if name == "K7"
              else fused_min_dist_sq_moving_broadcast)
        return fn(st["px"], st["py"], st["obs"], vel_b, torch.tensor(dts),
                  st["sx"], st["sy"], ap)

    got = batch()
    for b, d in enumerate(ds):
        want = _tpu_form_port(name, d, active[b], vels[b] if moving else None,
                              dts[b])
        assert torch.equal(got[0][b], want[0]) and torch.equal(got[1][b], want[1])
    monkeypatch.setattr(kernels, "_SLAB_ELEMS", 4 * 9 * 40 * 5)
    for a, b in zip(got, batch()):
        assert torch.equal(a, b)


def test_tpu_form_cpu_runs_count_no_launch_and_check_inputs():
    before = kernels.launch_counts()
    d = _inputs(26, S=4, T=3, O=8, G=8)
    vel = _velocities(26, 8)
    for name in TPU_FORMS:
        _tpu_form_port(name, d, 3, vel)
    assert kernels.launch_counts() == before
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    ap = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="G"):
        fused_min_dist_sq_broadcast_reference(t["px"], t["py"], t["obs"],
                                              t["sx"][:-1], t["sy"], ap)
    with pytest.raises(ValueError, match="obs_vel"):
        fused_min_dist_sq_moving_expanded(t["px"], t["py"], t["obs"],
                                          torch.from_numpy(vel[:-1].copy()),
                                          torch.tensor(0.1), t["sx"], t["sy"], ap)
    with pytest.raises(TypeError):
        fused_min_dist_sq_moving_broadcast(t["px"], t["py"], t["obs"],
                                           torch.from_numpy(vel).double(),
                                           torch.tensor(0.1), t["sx"], t["sy"], ap)


def test_fma_rn_is_correctly_rounded():
    """``_fma_rn`` rounds a * b + c once: on random floats of mixed
    magnitude against exact rationals, and where the float64 sum falls
    on a float32 midpoint that the exact value misses (``_fma`` rounds
    twice there: 1 + 2^-23 + 2^-24 (1 - 2^-40) rounds down, not to the
    even 1 + 2^-22)."""
    a, b, c = np.float32(1 + 2.0**-20), np.float32(2.0**-24 * (1 - 2.0**-20)), \
        np.float32(1 + 2.0**-23)
    assert float(_fma_t(a, b, c)) == 1 + 2.0**-23
    assert float(_fma(*(torch.tensor(v) for v in (a, b, c)))) == 1 + 2.0**-22
    rng = np.random.default_rng(7)
    n = 2000
    vals = [(rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)).astype(np.float32)
            for _ in range(3)]
    got = _fma_t(*vals).numpy()
    for x, y, z, g in zip(*vals, got):
        exact = fractions.Fraction(float(x)) * fractions.Fraction(float(y)) \
            + fractions.Fraction(float(z))
        lo = np.float32(float(exact))  # round to nearest through float64
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(fractions.Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert g == best, (x, y, z, g, best)


# --- the static kernel (K1, K2, K4, K6): several samples of one step per thread ---

import math

from kompass_core_tpu_torch.ops.kernels import (
    STATIC_BLOCK,
    STATIC_POINTS,
    _MAX_BATCH,
    _MAX_GRID_X,
    _static_points,
    sweep_points,
)

H100_SMS = 132
# the largest float32 at most 1e18: the static kernel's flag (kTame) is a
# value above it
TAME = np.float32(1e18)


def _min_nan(acc, d):
    """The kernels' NaN-keeping min: (d < acc || d != d) ? d : acc."""
    return torch.where((d < acc) | d.isnan(), d, acc)


def _flags(form, *values):
    """Whether values set a block's flag: K1 (direct) a non-finite one,
    K2 and K4 (expanded) and K6 (broadcast) one above 1e18 in magnitude
    (NaN included)."""
    if form == "direct":
        return ~torch.stack([torch.isfinite(v) for v in values]).all(0)
    return ~torch.stack([v.abs() <= 1e18 for v in values]).all(0)


def _static_pair(form, ox, oy, o2, px, py, keep_nan):
    """One (point, row) value as the kernel takes it: the expanded pair
    with the flag clear forms |o|^2 - 2 cross as one FMA; the broadcast
    pair takes the point as (-2px, -2py) and rounds every operation on
    its own either way."""
    if form == "direct":
        dx, dy = px - ox, py - oy
        return dx * dx + dy * dy
    if form == "broadcast":
        return (o2 + (-2.0 * px) * ox) + (-2.0 * py) * oy
    cross = ox * px + oy * py
    if keep_nan:
        return o2 - 2.0 * cross
    return _fma_rn(torch.full_like(cross, -2.0), cross, o2.expand_as(cross))


def _static_field(form, px, py, xs, ys, per_block, tile):
    """[B, S, T] points vs [B, n] rows: the running mins in the order of
    the static kernel. A block holds ``per_block`` samples of one step;
    its flag starts as any flagged value of its points (samples past S
    load 0). It sweeps the rows in tiles of ``tile``, each tile's mins by
    fminf (from +inf: NaN ignored) while the flag is clear and by the
    NaN-keeping min once a tile has set it."""
    B, S, T = px.shape
    n = xs.shape[1]
    runs = -(-S // per_block)
    pad = runs * per_block - S
    bx, by = (torch.nn.functional.pad(v, (0, 0, 0, pad)) for v in (px, py))
    flag = _flags(form, bx, by).view(B, runs, per_block, T).any(2)
    flag = flag.repeat_interleave(per_block, 1)[:, :S]  # [B, S, T]
    p_x, p_y = px[..., None], py[..., None]
    acc = torch.full_like(px, math.inf)
    for base in range(0, n, tile):
        ox, oy = (v[:, base:base + tile] for v in (xs, ys))
        o2 = ox * ox + oy * oy
        staged = (ox, oy) if form == "direct" else (ox, oy, o2)
        flag = flag | _flags(form, *staged).any(1)[:, None, None]
        ox, oy, o2 = (v[:, None, None, :] for v in (ox, oy, o2))
        keep = torch.amin(_static_pair(form, ox, oy, o2, p_x, p_y, True), -1)
        fast = _static_pair(form, ox, oy, o2, p_x, p_y, False)
        fast = torch.where(fast.isnan(), math.inf, fast).amin(-1)
        acc = torch.where(flag, _min_nan(acc, keep), torch.fmin(acc, fast))
    return acc


def _static_sweep(form, px, py, obs, sx, sy, active, tile, per_block=4):
    """The fields of K1 ("direct"), K2 ("expanded") or K6 ("broadcast"),
    or with ``sx`` None K4's one field ("expanded" over ``obs``), in the
    kernel's order: the running mins, the epilogue of the expanded and
    broadcast forms (+ |p|^2, clamp at 0 keeping a NaN), the mask.
    Returns a tuple of the fields."""
    rows = [(obs[..., 0], obs[..., 1])] + ([] if sx is None else [(sx, sy)])
    fields = [_static_field(form, px, py, xs, ys, per_block, tile)
              for xs, ys in rows]
    if form != "direct":
        pnorm = px * px + py * py
        fields = [torch.where(f + pnorm < 0.0, 0.0, f + pnorm) for f in fields]
    T = px.shape[-1]
    live = (torch.arange(T)[None, :] < active[:, None])[:, None, :]
    return tuple(torch.where(live, f, math.inf) for f in fields)


def _bits_equal(a, b):
    """Equal bit for bit, NaN where the other has NaN (any payload)."""
    if not torch.equal(a.isnan(), b.isnan()):
        return False
    a, b = (torch.where(v.isnan(), 0.0, v) for v in (a, b))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _static_case(seed, B=3, S=10, T=6, O=13, G=3):
    """Robot 0: NaN and +-inf points and rows; robot 1: 1e8 pad rows, a
    point exactly on an obstacle row and on a segment row; robot 2: values
    above 1e18 in points and rows. Three segment rows."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return torch.from_numpy(rng.uniform(-9.0, 9.0, shape).astype(np.float32))

    px, py, obs, sx, sy = u(B, S, T), u(B, S, T), u(B, O, 2), u(B, G), u(B, G)
    nan, inf = float("nan"), float("inf")
    px[0, 2, 1], py[0, 7, 4], px[0, 9, 0] = nan, inf, -inf
    obs[0, 3 % O, 0], obs[0, 8 % O] = -inf, torch.tensor([inf, nan])
    sy[0, 1] = nan
    obs[1, O - 4:] = 1e8
    obs[1, 5 % O] = torch.stack([px[1, 4, 2], py[1, 4, 2]])
    sx[1, 2], sy[1, 2] = px[1, 6, 3], py[1, 6, 3]
    # |o|^2 near the float32 limit and 2 cross past it: the FMA pair
    # would keep a finite value where the plain version has -inf
    obs[2, 6 % O] = torch.tensor([1.7e19, 0.0])
    px[2, 3, 0], py[2, 3, 0], sx[2, 0] = 1.06e19, 0.0, 5e18  # step 0: active
    # NaN from finite values in the broadcast form alone: |o|^2 = inf plus
    # (-2px) ox = -inf (the expanded cross cancels to 0 there)
    obs[2, 9 % O] = torch.tensor([1.5e19, -1.5e19])
    px[2, 7, 0], py[2, 7, 0] = 1.2e19, 1.2e19
    return px, py, obs, sx, sy


STATIC_FORMS = {"direct": fused_min_dist_sq_reference,
                "expanded": fused_min_dist_sq_expanded_reference,
                "broadcast": fused_min_dist_sq_broadcast_reference}


@pytest.mark.parametrize("form", sorted(STATIC_FORMS))
@pytest.mark.parametrize("tile", [1, 2, 3, 1024])
def test_static_order_of_operations_equals_the_plain_version(form, tile):
    """The kernel's order (tiles of rows, fminf until the block's flag is
    set and the NaN-keeping min after, the expanded FMA pair, the
    epilogue and the mask) gives the plain version's fields bit for bit
    at any tile size (1024 is the kernel's): NaN and +-inf in points and
    rows, NaN from finite values, pad rows, d2 = +0, values above 1e18,
    active steps below T; and at the evaluator's one obstacle row."""
    reference = STATIC_FORMS[form]
    px, py, obs, sx, sy = _static_case(40 + tile)
    ap = torch.tensor([6, 4, 1], dtype=torch.int32)
    got = _static_sweep(form, px, py, obs, sx, sy, ap, tile)
    want = reference(px, py, obs, sx, sy, ap)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    assert bool(want[0][0].isnan().any()) and not bool(want[0][1].isnan().any())
    if form == "direct":
        assert float(want[0][1, 4, 2]) == 0.0 and float(want[1][1, 6, 3]) == 0.0
    else:
        assert float(want[0][2, 3, 0]) == 0.0  # -inf, clamped
    assert bool(want[0][2, 7, 0].isnan()) == (form == "broadcast")
    # one obstacle row (a 1e8 pad, as the evaluator has)
    px, py, obs, sx, sy = _static_case(50 + tile, S=10, T=5, O=1, G=11)
    obs[:] = 1e8
    ap = torch.tensor([5, 3, 2], dtype=torch.int32)
    got = _static_sweep(form, px, py, obs, sx, sy, ap, tile, per_block=2)
    for g, w in zip(got, reference(px, py, obs, sx, sy, ap)):
        assert _bits_equal(g, w)


@pytest.mark.parametrize("tile", [1, 2, 3, 1024])
def test_k4_static_order_of_operations_equals_the_plain_version(tile):
    """K4 is the static kernel's expanded form with the segment sweep
    compiled out: one field over the given rows, in the kernel's order,
    equals ``min_dist_sq_expanded_reference`` bit for bit at any tile
    size, over the obstacle rows and over the segment rows (the two
    launches of a ``pallas_v1`` solve), on the edge cases of the fused
    sweeps; and it is K2's field over the same rows."""
    px, py, obs, sx, sy = _static_case(80 + tile)
    ap = torch.tensor([6, 4, 1], dtype=torch.int32)
    seg = torch.stack([sx, sy], dim=-1).contiguous()
    k2 = fused_min_dist_sq_expanded_reference(px, py, obs, sx, sy, ap)
    for rows, k2_field in ((obs, k2[0]), (seg, k2[1])):
        (got,) = _static_sweep("expanded", px, py, rows, None, None, ap, tile)
        want = min_dist_sq_expanded_reference(px, py, rows, ap)
        assert _bits_equal(got, want) and _bits_equal(want, k2_field)
    assert bool(k2[0][0].isnan().any()) and not bool(k2[0][1].isnan().any())
    assert float(k2[0][2, 3, 0]) == 0.0
    # one row, a 1e8 pad; and 40 rows
    for O, per_block in ((1, 2), (40, 4)):
        px, py, obs, _, _ = _static_case(90 + tile, S=10, T=5, O=O, G=3)
        obs[:, :1] = 1e8
        ap = torch.tensor([5, 3, 1], dtype=torch.int32)
        (got,) = _static_sweep("expanded", px, py, obs, None, None, ap, tile,
                               per_block)
        assert _bits_equal(got, min_dist_sq_expanded_reference(px, py, obs, ap))


def test_broadcast_pair_below_1e18_is_never_nan():
    """The static kernel's flag for K6: where every point coordinate and
    every staged value (ox, oy, |o|^2) is at most 1e18 in magnitude, the
    broadcast pair (|o|^2 + (-2px) ox) + (-2py) oy stays below 4e36 +
    1e18 and its epilogue + |p|^2 below 6e36, so neither is NaN or
    infinite and fminf is the NaN-keeping min there. Every combination
    of the edge magnitudes, and random log-uniform ones."""
    edges = np.array([0.0, 1e-45, 1.0, 1e9, 3e17, TAME], np.float32)
    edges = np.concatenate([edges, -edges[1:]])
    grid = np.stack(np.meshgrid(*[edges] * 5, indexing="ij"), -1).reshape(-1, 5)
    rng = np.random.default_rng(5)
    mag = 10.0 ** rng.uniform(-40, 18, (200_000, 5))
    rand = (np.sign(rng.uniform(-1, 1, mag.shape)) * mag).astype(np.float32)
    vals = torch.from_numpy(np.concatenate([grid, np.minimum(np.abs(rand), TAME)
                                            * np.sign(rand)]))
    px, py, ox, oy, o2 = vals.unbind(-1)
    assert bool((vals.abs() <= 1e18).all())
    assert not bool(_flags("broadcast", px, py, ox, oy, o2).any())
    pair = _static_pair("broadcast", ox, oy, o2, px, py, keep_nan=False)
    assert bool(torch.isfinite(pair).all())
    assert bool(pair.abs().max() <= 4.0001e36)
    assert bool(torch.isfinite(pair + (px * px + py * py)).all())
    # one step further, it can be NaN: |o|^2 = inf against -2px ox = -inf
    big = torch.tensor([2e19], dtype=torch.float32)
    over = _static_pair("broadcast", big, big * 0, big * big, big / 2, big * 0, True)
    assert bool(over.isnan().all()) and bool(_flags("broadcast", big).all())


@pytest.mark.parametrize("tile", [7, 64])
def test_k2_fma_pair_equals_the_separate_operations_below_1e18(tile):
    """Where no value passes 1e18, |o|^2 - 2 cross as one FMA equals the
    multiply and the subtract bit for bit (2 cross is exact): 200k pairs
    at the JAX package's coordinates and at a million metres, every
    block's flag clear."""
    rng = np.random.default_rng(60 + tile)
    for span in (10.0, 1e6):
        def u(*shape):
            return torch.from_numpy(rng.uniform(-span, span, shape).astype(np.float32))

        px, py, obs, sx, sy = u(2, 64, 8), u(2, 64, 8), u(2, 150, 2), u(2, 50), u(2, 50)
        ap = torch.tensor([8, 5], dtype=torch.int32)
        got = _static_sweep("expanded", px, py, obs, sx, sy, ap, tile, per_block=16)
        want = fused_min_dist_sq_expanded_reference(px, py, obs, sx, sy, ap)
        for g, w in zip(got, want):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_sweep_points_at_the_path_shapes():
    """8 samples per thread where the grid already fills the card (64
    robots, the cost evaluator); at one robot's flagship tick, and at the
    k-tick loop's 4-robot test fleet, 2."""
    assert sweep_points(64, 2025, 30, H100_SMS) == 8
    assert sweep_points(1, 5001, 1000, H100_SMS) == 8
    assert sweep_points(1, 2025, 30, H100_SMS) == 2
    assert sweep_points(4, 144, 20, H100_SMS) == 2
    # one robot: 60 blocks of 4 warps at kPts = 8, short of two per scheduler
    assert 60 * (STATIC_BLOCK // 32) < 2 * 4 * H100_SMS


# (wrapper, its C entry point, the obstacle rows of its path, segment rows)
_STATIC_WRAPPERS = {
    "K1": (fused_min_dist_sq, "kompass_fused_min_dist_sq", 512, 384),
    "K2": (fused_min_dist_sq_expanded, "kompass_fused_min_dist_sq_expanded", 512, 384),
    "K4": (min_dist_sq_expanded, "kompass_min_dist_sq_expanded", 512, 0),
    "K6": (fused_min_dist_sq_broadcast, "kompass_fused_min_dist_sq_broadcast",
           768, 384),
}


def _static_call(name, px, py, obs, sx, sy, ap, **kw):
    """A static wrapper's fields as a tuple (K4: one field, over ``obs``)."""
    wrapper = _STATIC_WRAPPERS[name][0]
    if name == "K4":
        return (wrapper(px, py, obs, ap, **kw),)
    return wrapper(px, py, obs, sx, sy, ap, **kw)


@pytest.mark.parametrize("name", ["K4", "K6"])
def test_k4_and_k6_launch_the_static_kernel_at_sweep_points(name, monkeypatch):
    """On a card of 132 SMs, K4 and K6 launch their static entry point
    with kPts = 2 at one robot's 2025 x 30 points and 8 at 64 robots
    (their path shapes: K4 against 512 rows, K6 against 768 + 384), the
    same as ``sweep_points``; a forced kPts reaches the launch as given.
    The launch itself is replaced: the inputs are checked as on a card."""
    wrapper, entry, O, G = _STATIC_WRAPPERS[name]
    launched = []

    def launch(fn, dims, *args, extra=()):
        launched.append((fn, dims, extra))
        return ()

    monkeypatch.setattr(kernels, "_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(kernels, "_launch", launch)
    for B, want in ((1, 2), (64, 8)):
        assert sweep_points(B, 2025, 30, H100_SMS) == want
        px, py = torch.zeros(B, 2025, 30), torch.zeros(B, 2025, 30)
        obs = torch.zeros(B, O, 2)
        seg = (None, None) if name == "K4" else (torch.zeros(B, G), torch.zeros(B, G))
        ap = torch.full((B,), 30, dtype=torch.int32)
        for forced in (None, *STATIC_POINTS):
            kernels._static_launch(wrapper.__name__, px, py, obs, *seg, ap, forced)
            assert launched[-1] == (entry, (B, 2025, 30, O, G, True),
                                    (want if forced is None else forced,))


@pytest.mark.parametrize("B", [1, 2, 4, 64, 1024, _MAX_BATCH])
@pytest.mark.parametrize("S,T", [(1, 1), (37, 7), (144, 20), (1025, 30),
                                 (2025, 30), (5001, 1000), (1, 2**20)])
def test_sweep_points_stay_inside_the_cards_limits(B, S, T):
    """kPts is one the kernel is built for, 2 only where the grid at 8 is
    short of two warps per scheduler; the grid (steps x runs, robots) fits
    its dimensions."""
    k = sweep_points(B, S, T, H100_SMS)
    assert k in STATIC_POINTS
    blocks = B * T * -(-S // (STATIC_BLOCK * 8))
    assert (k == 2) == (blocks * (STATIC_BLOCK // 32) < 2 * 4 * H100_SMS)
    assert -(-S // (STATIC_BLOCK * k)) * T <= _MAX_GRID_X and B <= _MAX_BATCH
    assert _static_points("K1", (B, S, T), k, None) == k


def test_sweep_points_follow_the_cards_sm_count():
    """The same grid fills a card of fewer SMs and not one of more: 4
    robots' 2025 x 30 points make 240 blocks of 4 warps, two warps per
    scheduler of 114 SMs (an H100 PCIe) but not of 132."""
    assert sweep_points(4, 2025, 30, 114) == 8
    assert sweep_points(4, 2025, 30, H100_SMS) == 2


def test_forced_points_are_checked_before_any_launch():
    with pytest.raises(ValueError, match="samples per thread"):
        _static_points("K1", (1, 2025, 30), 4, None)
    with pytest.raises(ValueError, match="samples per thread"):
        _static_points("K2", (1, 2025, 30), 3, None)
    with pytest.raises(ValueError, match="blocks"):
        _static_points("K1", (1, 1, 2**31), 2, None)
    assert _static_points("K1", (1, 1, 2**30), 2, None) == 2
    # on the CPU the wrappers run the plain version whatever the points
    px, py, obs, sx, sy = _static_case(70)
    ap = torch.tensor([6, 4, 1], dtype=torch.int32)
    for wrapper, plain in ((fused_min_dist_sq, fused_min_dist_sq_reference),
                           (fused_min_dist_sq_expanded,
                            fused_min_dist_sq_expanded_reference)):
        for g, w in zip(wrapper(px, py, obs, sx, sy, ap, _points=2),
                        plain(px, py, obs, sx, sy, ap)):
            assert _bits_equal(g, w)


@pytest.mark.parametrize("name", sorted(_STATIC_WRAPPERS))
def test_forced_points_outside_the_kernel_raise_in_every_static_wrapper(name):
    """A kPts the static kernel is not built for raises in each wrapper,
    on the CPU too (no plain version runs); one it is built for gives the
    plain version's fields there."""
    px, py, obs, sx, sy = _static_case(71)
    ap = torch.tensor([6, 4, 1], dtype=torch.int32)
    for points in (0, 1, 3, 4, 16):
        with pytest.raises(ValueError, match="samples per thread"):
            _static_call(name, px, py, obs, sx, sy, ap, _points=points)
    want = _static_call(name, px, py, obs, sx, sy, ap)
    for points in STATIC_POINTS:
        got = _static_call(name, px, py, obs, sx, sy, ap, _points=points)
        for g, w in zip(got, want):
            assert _bits_equal(g, w)


# --- K10: the goal cost's nearest segment point ------------------------------------

from kompass_core_tpu.ops.solver import _goal_cost as jax_goal_cost  # noqa: E402
from kompass_core_tpu.ops.solver import _pad_sweep_pow2  # noqa: E402
from kompass_core_tpu_torch.ops import solver as port_solver  # noqa: E402
from kompass_core_tpu_torch.ops.kernels import (  # noqa: E402
    GOAL_LAYOUTS,
    goal_layout,
    goal_nearest,
    goal_nearest_reference,
)

GOAL_CASES = ("plain", "ties", "nan_end", "all_pads", "g1", "g70", "g1088")
GOAL_LEADS = ("none", "one", "three")


def _goal_case(case, lead, S=37):
    """(end_x, end_y, seg_x, seg_y) as float32 numpy [B, S] and [B, G]:
    segment points within 6 m padded at 1e8 past ``count``, end points
    around them; ``case`` sets G or an edge, ``lead`` B (one robot with
    no leading axis for "none")."""
    B = 3 if lead == "three" else 1
    G = {"g1": 1, "g70": 70, "g1088": 1088}.get(case, 48)
    rng = np.random.default_rng([GOAL_CASES.index(case), GOAL_LEADS.index(lead)])
    seg_x = np.full((B, G), 1e8, np.float32)
    seg_y = np.full((B, G), 1e8, np.float32)
    count = 0 if case == "all_pads" else max(1, G - G // 5)
    seg_x[:, :count] = rng.uniform(-6, 6, (B, count))
    seg_y[:, :count] = rng.uniform(-6, 6, (B, count))
    end_x = rng.uniform(-7, 7, (B, S)).astype(np.float32)
    end_y = rng.uniform(-7, 7, (B, S)).astype(np.float32)
    if case == "ties":
        # points 3 and 10 coincide, and some end points sit on them: the
        # first index wins at distance 0
        seg_x[:, 10], seg_y[:, 10] = seg_x[:, 3], seg_y[:, 3]
        end_x[:, ::4], end_y[:, ::4] = seg_x[:, 3:4], seg_y[:, 3:4]
    if case == "nan_end":
        end_x[:, 5] = np.nan
        end_y[-1, 9] = np.nan
    return end_x, end_y, seg_x, seg_y


def _goal_tensors(arrays, lead):
    t = [torch.from_numpy(a) for a in arrays]
    return [v[0] for v in t] if lead == "none" else t


def _broadcast_search(end_x, end_y, seg_x, seg_y):
    """The goal cost's search as ``_goal_cost`` wrote it before K10: the
    [.., S, G] broadcast, argmin and amin."""
    dx = end_x.unsqueeze(-1) - seg_x.unsqueeze(-2)
    dy = end_y.unsqueeze(-1) - seg_y.unsqueeze(-2)
    d2 = dx * dx + dy * dy
    return torch.amin(d2, dim=-1), torch.argmin(d2, dim=-1)


def _jax_search(end_x, end_y, seg_x, seg_y):
    """The JAX package's ``_goal_cost`` search for one robot, as it writes
    it: the segment padded to a power of two with 1e8, then argmin, min."""
    sx, sy = _pad_sweep_pow2(jnp.asarray(seg_x)), _pad_sweep_pow2(jnp.asarray(seg_y))
    ex, ey = jnp.asarray(end_x), jnp.asarray(end_y)
    d2 = (ex[:, None] - sx[None, :]) ** 2 + (ey[:, None] - sy[None, :]) ** 2
    return np.array(jnp.min(d2, axis=1)), np.array(jnp.argmin(d2, axis=1))


@pytest.mark.parametrize("lead", GOAL_LEADS)
@pytest.mark.parametrize("case", GOAL_CASES)
def test_goal_search_equals_broadcast_search_and_jax(case, lead):
    """K10's operator on the CPU (its plain version) gives the search the
    goal cost made before it and the JAX package's, bit for bit: the
    first index on ties, NaN and the first index for a NaN end point, the
    first pad for a row of pads; and counts no launch."""
    arrays = _goal_case(case, lead)
    args = _goal_tensors(arrays, lead)
    before = kernels.launch_counts()
    got = goal_nearest(*args)
    assert kernels.launch_counts() == before
    for g, w in zip(got, torch.ops.kompass_torch.goal_nearest(*args)):
        assert _bits_equal(g, w) if g.is_floating_point() else torch.equal(g, w)
    want = _broadcast_search(*args)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    assert got[0].shape == got[1].shape == args[0].shape
    assert _bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])
    min_d2, index = (t.reshape(-1, arrays[0].shape[1]).numpy() for t in got)
    for b in range(arrays[0].shape[0]):
        jmin, jarg = _jax_search(*(a[b] for a in arrays))
        assert _bits_equal(torch.from_numpy(min_d2[b]), torch.from_numpy(jmin)), b
        assert np.array_equal(index[b], jarg), b
    if case == "ties":
        assert (index[:, ::4] == 3).all()
    if case == "nan_end":
        assert np.isnan(min_d2[:, 5]).all() and (index[:, 5] == 0).all()
    if case == "all_pads":
        assert (index == 0).all()


@pytest.mark.parametrize("case", ("plain", "ties", "nan_end", "all_pads", "g1088"))
def test_goal_cost_equals_jax_goal_cost(case):
    """The port's ``_goal_cost`` over three robots, K10 inside, against the
    JAX package's ``_goal_cost`` robot by robot: end points at step
    ``active - 1`` of [S, T] rollouts, the segment's arc lengths, the
    path's length. Within one float32 ulp, NaN where JAX has NaN: the
    search is bit for bit (above), but PyTorch's CPU float32 ``sqrt`` of
    the distance is not correctly rounded on every host (XLA's is), an ulp
    that the tie-breaker term carries into the cost."""
    end_x, end_y, seg_x, seg_y = _goal_case(case, "three")
    B, S = end_x.shape
    T, active = 6, 4
    rng = np.random.default_rng(GOAL_CASES.index(case) + 40)
    px = rng.uniform(-7, 7, (B, S, T)).astype(np.float32)
    py = rng.uniform(-7, 7, (B, S, T)).astype(np.float32)
    px[:, :, active - 1], py[:, :, active - 1] = end_x, end_y
    arc = np.cumsum(rng.uniform(0, 0.2, seg_x.shape), axis=1).astype(np.float32)
    total = np.float32(30.0)
    got = port_solver._goal_cost(
        torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(seg_x),
        torch.from_numpy(seg_y), torch.from_numpy(arc),
        torch.full((B,), float(total)), torch.full((B,), active, dtype=torch.int32))
    for b in range(B):
        want = np.asarray(jax_goal_cost(
            jnp.asarray(px[b]), jnp.asarray(py[b]), jnp.asarray(seg_x[b]),
            jnp.asarray(seg_y[b]), jnp.asarray(arc[b]), jnp.float32(total),
            jnp.int32(active)))
        assert np.array_equal(np.isnan(got[b].numpy()), np.isnan(want)), b
        np.testing.assert_array_max_ulp(got[b].numpy(), want, maxulp=1)


@pytest.mark.parametrize(
    "change,error",
    [
        (dict(end_x=lambda t: t.double()), TypeError),
        (dict(seg_y=lambda t: t.half()), TypeError),
        (dict(seg_x=lambda t: t[:2].contiguous()), ValueError),  # robot axes differ
        (dict(end_y=lambda t: t[:2].contiguous()), ValueError),
        (dict(seg_x=lambda t: t[0], seg_y=lambda t: t[0]), ValueError),
        (dict(seg_x=lambda t: t[:, :0], seg_y=lambda t: t[:, :0]), ValueError),
        (dict(end_x=lambda t: t[:, ::2], end_y=lambda t: t[:, ::2]), ValueError),
        (dict(seg_x=lambda t: t.to("meta")), ValueError),
    ],
)
def test_goal_nearest_rejects_what_the_kernel_does_not_take(change, error):
    """Wrong dtypes, mismatched robot axes, empty segments, strided and
    mixed-device inputs raise, on the CPU too."""
    args = dict(zip(("end_x", "end_y", "seg_x", "seg_y"),
                    _goal_tensors(_goal_case("plain", "three"), "three")))
    for k, fn in change.items():
        args[k] = fn(args[k])
    with pytest.raises(error):
        goal_nearest(**args)


def test_goal_layouts_follow_the_grid_and_forced_ones_are_checked():
    """64, 256 and 1024 robots take 2 samples a thread, one robot's
    2025 samples and the evaluator's 5001 split G across a warp; a forced
    layout outside GOAL_LAYOUTS raises, one inside gives the plain
    version on the CPU."""
    assert [GOAL_LAYOUTS[goal_layout(B, 2025, H100_SMS)] for B in (1024, 256, 64, 1)] == [
        (2, False), (2, False), (2, False), (4, True)]
    assert GOAL_LAYOUTS[goal_layout(1, 5001, H100_SMS)] == (4, True)
    args = _goal_tensors(_goal_case("plain", "three"), "three")
    for layout in (-1, len(GOAL_LAYOUTS)):
        with pytest.raises(ValueError, match="layout"):
            goal_nearest(*args, _layout=layout)
    want = goal_nearest_reference(*args)
    for layout in range(len(GOAL_LAYOUTS)):
        got = goal_nearest(*args, _layout=layout)
        assert _bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])
