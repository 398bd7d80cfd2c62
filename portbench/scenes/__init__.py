"""Traffic scenes, one module per scene, found by the traffic file's
``scene`` key: ``portbench/scenes/<scene>.py`` with a class
``Scene(traffic, cfg, seed)``.

A traffic file (``portbench/traffic/<mix>.json``) names its scene and
gives the scene's parameters; the scene makes every call's inputs from
the seed (``inputs()``) and advances by the call's outputs
(``advance(out)``), and gives what its system reads (``systems/``).
Seeds change offsets, headings and returns, never sizes: every seed
gives the same shapes and the same number of restarts per call.
"""

import numpy as np


def step(s, vx, vy, om, dt):
    """Integrate one command over one control step, in place."""
    c, sn = np.cos(s[:, 2]), np.sin(s[:, 2])
    s[:, 0] += dt * (vx * c - vy * sn)
    s[:, 1] += dt * (vx * sn + vy * c)
    s[:, 2] += dt * om
    s[:, 3] = np.hypot(vx, vy)
