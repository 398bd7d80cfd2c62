"""K9's headings at the collision margin: the port against the JAX package.

A BOX robot's collision field turns each obstacle row into the body frame
with the heading's cos and sin. The port takes torch's (``ops/solver.py::
_min_box_dist_sq``), the JAX package XLA's, which differ by an ulp now
and then, so a decision ``d2 < margin^2`` can differ where d2 lies within
a few ulps of margin^2. ``chip_smoke.heading_probe`` puts 4 x 128 x 32
points on the margin's contour of two 0.5 x 0.3 m BOXes and two (0, 0)
circles, over 1024 random headings yaw0 + omega * t * dt per robot, with
static and with moving rows: half of them at margin^2 itself, half
spread over +-64 ulps of it.

Counted on this probe (16384 points per row kind):

- against JAX compiled without FMA (each operation rounded on its own,
  as the card's kernel rounds it): 295 decisions differ with static rows
  and 282 with moving rows, the farthest 5 and 7 ulps of margin^2 from
  it;
  given XLA's headings none differs (the field is bit for bit JAX's), so
  the headings make every one of them;
- against JAX under ``jax.jit`` (XLA's CPU backend fuses multiply-adds,
  in the field and in its cos and sin): 1655 and 2175, the farthest 10
  and 19 ulps from it.

About 57% of the points lie within 8 ulps of margin^2, the farthest 71
ulps from it. No decision differs farther from the margin than 19 ulps
(2.3e-6 of margin^2): the headings flip decisions at the margin alone,
and XLA's CPU cos and sin could not be matched in torch without its
polynomial and its FMAs. So the port keeps
torch's headings under a tie rule (ROADMAP fault 2): a collision decision
may differ from the JAX package's only where JAX's d2 lies within
``TIE_ULPS`` ulps of margin^2 (``JIT_TIE_ULPS`` against ``jax.jit``).
These tests pin that rule, and that the port's d2 lies within as many
ulps of margin^2 from JAX's (at most 7 and 8 without FMA, 14 and 22
under ``jax.jit``). ``chip_smoke.py`` holds the card's decisions to
``TIE_ULPS`` against the CPU's on the same probe (the CPU's d2 as the
reference), so the card's differ from JAX's only where JAX's d2 lies
within 2 * TIE_ULPS ulps of margin^2 (TIE_ULPS + JIT_TIE_ULPS against
``jax.jit``).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    HEADING_SHAPE, TIE_ULPS, heading_flips, heading_probe, heading_probe_fields,
)
from kompass_core_tpu_torch.ops import kernels
from test_torch_kernels import jax_without_fma

torch.set_num_threads(2)

JIT_TIE_ULPS = 24  # against JAX under jax.jit: 19 measured (TIE_ULPS: 7)


def _jax_fields():
    """Each probe case's JAX box field, and XLA's cos and sin of the
    probe's yaw, under ``jax.jit``: {"moving/key": [B, S, T]}."""
    import jax
    import jax.numpy as jnp
    from kompass_core_tpu.ops import solver as jsolver

    yaw0, omega, dt, half, _, cases = heading_probe()
    T = HEADING_SHAPE[1]
    mask = jnp.ones(T, bool)

    @jax.jit
    def field(px, py, rows, vel, yaw0, omega, hl, hw):
        params = jsolver.SolverParams(*([dt] + [jnp.float32(0.0)] * 11))
        vels = jnp.zeros((omega.shape[0], 3), jnp.float32).at[:, 2].set(omega)
        state = jnp.stack([jnp.float32(0.0), jnp.float32(0.0), yaw0])
        d2 = jsolver._min_box_dist_sq(None, params, state, vels, px, py, rows, mask,
                                      box_hl=hl, box_hw=hw, obs_vel=vel)
        yaw = state[2] + vels[:, 2:3] * jnp.arange(T, dtype=jnp.float32)[None, :] * dt
        return d2, jnp.cos(yaw), jnp.sin(yaw)

    fields = {}
    for moving, (px, py, rows, vel) in cases.items():
        per_robot = [field(px[b], py[b], rows[b], None if vel is None else vel[b],
                           yaw0[b], omega[b], half[b, 0], half[b, 1])
                     for b in range(len(yaw0))]
        for i, key in enumerate(("d2", "cos", "sin")):
            fields[f"{moving}/{key}"] = np.stack([np.asarray(f[i]) for f in per_robot])
    return fields


def jax_fields_without_fma():
    """``_jax_fields`` for ``test_torch_kernels.jax_without_fma``."""
    return _jax_fields()


@pytest.fixture(scope="module")
def without_fma(tmp_path_factory):
    return jax_without_fma("test_torch_box_headings",
                           tmp_path_factory.mktemp("no_fma") / "headings.npz")


@pytest.fixture(scope="module")
def with_fma():
    return _jax_fields()


@pytest.fixture(scope="module")
def probe():
    return heading_probe()


@pytest.fixture(scope="module")
def port(probe):
    return heading_probe_fields(probe, "cpu")


def _xla_headings_field(probe, moving, cos, sin):
    """K9's plain version on the probe case given XLA's headings."""
    _, _, dt, half, _, cases = probe
    px, py, rows, vel = cases[moving]
    B, _, T = px.shape
    t = {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v))
         for k, v in dict(px=px, py=py, rows=rows, vel=vel, cos=cos, sin=sin,
                          half=half).items()}
    return kernels.box_min_dist_sq(
        t["px"], t["py"], t["cos"], t["sin"], t["rows"], t["vel"],
        torch.full((B,), float(dt)), t["half"],
        torch.full((B,), T, dtype=torch.int32)).numpy()


def _ulps_apart(got, want, margin):
    """The largest |got - want| in ulps of margin^2."""
    r2 = (margin * margin)[:, None, None]
    return float((np.abs(got.astype(np.float64) - want) / np.spacing(r2)).max())


@pytest.mark.parametrize("moving", [False, True])
def test_heading_probe_sits_on_the_margin(probe, without_fma, moving):
    """The probe is sharp: half of its points lie within TIE_ULPS ulps of
    margin^2 by JAX's own d2, and the spread half reaches 64 ulps."""
    margin = probe[4]
    want = without_fma[f"{moving}/d2"]
    r2 = (margin * margin)[:, None, None]
    ulps = np.abs(want.astype(np.float64) - r2) / np.spacing(r2)
    assert (ulps <= TIE_ULPS).sum() >= want.size // 2
    assert ulps.max() >= 48
    assert np.isfinite(want).all()


@pytest.mark.parametrize("moving", [False, True])
def test_heading_flips_against_jax_without_fma_stay_at_the_margin(
        probe, port, without_fma, moving):
    """Against JAX compiled without FMA: decisions differ (295 static, 282
    moving on this probe), every one within TIE_ULPS ulps of margin^2,
    and the port's d2 within TIE_ULPS ulps of margin^2 from JAX's; given
    XLA's headings the port's field is JAX's bit for bit, so the headings
    alone make them."""
    margin = probe[4]
    want = without_fma[f"{moving}/d2"]
    flips, ulps = heading_flips(port[moving], want, margin)
    assert flips > 0 and ulps <= TIE_ULPS, (flips, ulps)
    apart = _ulps_apart(port[moving], want, margin)
    assert apart <= TIE_ULPS, apart
    xla = _xla_headings_field(probe, moving, without_fma[f"{moving}/cos"],
                              without_fma[f"{moving}/sin"])
    np.testing.assert_array_equal(xla, want)
    assert heading_flips(xla, want, margin) == (0, 0.0)


@pytest.mark.parametrize("moving", [False, True])
def test_heading_flips_against_jax_jit_stay_at_the_margin(probe, port, with_fma,
                                                         moving):
    """Against JAX under ``jax.jit`` (FMAs in the field and in XLA's cos
    and sin): decisions differ (1655 static, 2175 moving), every one
    within JIT_TIE_ULPS ulps of margin^2, and the port's d2 within
    JIT_TIE_ULPS ulps of margin^2 from JAX's."""
    want = with_fma[f"{moving}/d2"]
    flips, ulps = heading_flips(port[moving], want, probe[4])
    assert flips > 0 and ulps <= JIT_TIE_ULPS, (flips, ulps)
    apart = _ulps_apart(port[moving], want, probe[4])
    assert apart <= JIT_TIE_ULPS, apart
