"""Angle normalization helpers.

Equivalent functionality to the reference's ``utils/angles.h:5`` (Angle
namespace): normalization into [0, 2pi) and [-pi, pi]. Works on scalars and
numpy arrays.
"""

import numpy as np


def normalize_to_0_2pi(angle):
    """Normalize angle(s) into [0, 2*pi)."""
    return np.mod(angle, 2.0 * np.pi)


def normalize_to_minus_pi_pi(angle):
    """Normalize angle(s) into [-pi, pi]. Signed shortest representation."""
    a = np.mod(np.asarray(angle) + np.pi, 2.0 * np.pi) - np.pi
    return a if isinstance(angle, np.ndarray) else float(a)
