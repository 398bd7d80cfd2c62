"""The port's dynamic window (ops/window.py, float64 on the host) against
the JAX package's, bit for bit: the tests/test_window.py cases plus a
randomized sweep."""

import numpy as np
import pytest

from kompass_core_tpu.ops import window as jwin
from kompass_core_tpu_torch.ops import window as twin

LIMITS = np.array([1.0, 5.0, 10.0, 0.0, 0.0, 0.0, 2.0, 3.0, 3.0])
NO_ACC = LIMITS.copy()
NO_ACC[1] = NO_ACC[2] = 0.0


def _assert_same_window(args):
    a = jwin.sample_velocity_window(*args)
    b = twin.sample_velocity_window(*args)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize(
    "args",
    [
        ((0.5, 0, 0.1), LIMITS, 0.1, 5, 1, 5, False),  # accel-limited
        ((0.95, 0, 0.0), LIMITS, 0.1, 5, 1, 5, False),  # capped at max_vel
        ((0.5, 0, 0.0), NO_ACC, 0.1, 5, 1, 5, False),  # zero-width window
        ((0.2, 0, 0.0), LIMITS, 0.1, 7, 1, 5, False),  # grid accumulation
    ],
)
def test_window_cases_bit_exact(args):
    _assert_same_window(args)


def test_randomized_windows_bit_exact():
    rng = np.random.default_rng(7)
    for _ in range(200):
        limits = rng.uniform(0.5, 6.0, 9)
        vel = tuple(rng.uniform(-limits[i], limits[i]) for i in (0, 3, 6))
        is_omni = bool(rng.integers(0, 2))
        if not is_omni:
            limits[3:6] = 0.0
        n_vx, n_vy = twin.compute_linear_sample_split(is_omni, 7)
        _assert_same_window(
            (vel, limits, 0.1, n_vx, n_vy, twin.num_angular_slots(6), is_omni)
        )


def test_sample_split_and_constants():
    assert twin.MIN_VEL == jwin.MIN_VEL == 0.01
    for n in range(1, 40):
        for omni in (False, True):
            assert twin.compute_linear_sample_split(omni, n) == (
                jwin.compute_linear_sample_split(omni, n)
            )
        assert twin.num_angular_slots(n) == jwin.num_angular_slots(n)
