"""The generator: one seed gives one traffic, another seed another, with
the same shapes."""

import numpy as np
import pytest

from portbench.harness.main import make_scene
from portbench.tests.tiny import VARIANTS, tiny_cell


def calls(variant, seed, n=6):
    cfg, traffic, _ = tiny_cell(*variant)
    scene = make_scene(traffic, cfg, seed)
    out = [[np.copy(p) for p in scene.paths]]
    for _ in range(n):
        s, v, r, trk = scene.inputs()
        out.append([np.copy(s), np.copy(v), np.copy(r)] + ([] if trk is None else [np.copy(trk)]))
        zero = {f: np.full((scene.n,) + ((scene.k,) if scene.k > 1 else ()), 0.1, np.float32)
                for f in ("vx", "vy", "omega")}
        zero["final_states"] = s + 0.05
        scene.advance(zero)
    return out


def same(a, b):
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return np.array_equal(a, b, equal_nan=True) if isinstance(a, np.ndarray) else a == b


def shapes(a):
    if isinstance(a, list):
        return [shapes(x) for x in a]
    return a.shape if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_seed_one_traffic(variant):
    assert same(calls(variant, 2**31 + 12345), calls(variant, 2**31 + 12345))


@pytest.mark.parametrize("variant", VARIANTS)
def test_seeds_differ_in_values_not_shapes(variant):
    a, b = calls(variant, 2**31 + 1), calls(variant, 2**31 + 2)
    assert not same(a, b)
    assert shapes(a) == shapes(b)
