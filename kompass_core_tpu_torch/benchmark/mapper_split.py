"""Where a dense mapper update's time goes: the beam side, the cell pass
(K5) and the whole update.

Counterpart of ``kompass_core_tpu/benchmark/mapper_split.py``, which
splits the JAX update into its candidate lookup (the one-hot x tables
dot that TPU kernel K5 computes) and the whole ``scan_to_grid``, and
reports ``lookup_only_ms``, ``full_update_ms`` and ``rest_ms``. The port
splits the update where its code splits it (``ops/mapping.py``): the beam
side in plain PyTorch (``_beam_side``: validity, endpoint cells, the
per-beam tables, the endpoint scatter) and the per-cell pass
(``kernels.scan_to_grid_cells``, K5, whose kernel does the lookup, the
line test and the combine). ``main`` slope-times, one distinct variant
per dispatch, each part in turns with the others and the median of
``repeats`` turns kept, at the JAX spec (400 x 400 cells at 0.05 m,
3600 bins) on uniform 0.5-9.5 m ranges from ``default_rng(0)``:

* ``beam_side_ms``: the beam side alone;
* ``cells_ms``: the cell pass alone, on tables the beam side prepared
  beforehand (JAX's ``lookup_only_ms``);
* ``full_update_ms``: the whole ``scan_to_grid`` (``get_scan_to_grid``);
* ``rest_ms``: the whole update less the cell pass, what no faster K5
  could save (JAX's ``rest_ms``);

and the same three by the device loop (``device_loop._device_loop``: K
chained iterations as one CUDA graph, the time from the K-delta), which
takes the host's enqueue out.

``shootout`` (``--modes``) is JAX's lookup shoot-out. The JAX package
has three forms of one lookup function (``KOMPASS_TPU_LOOKUP`` = full,
banded or pallas, ``kompass_core_tpu/ops/mapping.py:377``); the port has
one lookup form, so its forms are the update through K5 and through K5's
plain version (``scan_to_grid_cells_reference``), checksum-equal on one
input, then each slope-timed.

Run on the card: ``python -m kompass_core_tpu_torch.benchmark.mapper_split
--device cuda [--modes]`` (prints the JSON, writes no file).
"""

from __future__ import annotations

import json
import statistics

import numpy as np
import torch

from ..ops.kernels import OCCUPIED

LOOP_KS = (8, 56)  # the device loop's chain lengths (device_loop.main's mapper)


def _spec(spec):
    from .runner import mapper_spec

    return spec or mapper_spec()


def _ranges(rng, spec, count, device):
    from .runner import resident

    return resident([
        torch.from_numpy(rng.uniform(0.5, 9.5, spec.num_bins).astype(np.float32)).to(device)
        for _ in range(count)
    ], device)


def split_fns(spec, device):
    """(beam_side(ranges [B]) -> (tables, endpoint), cells((tables,
    endpoint)) -> occ [1, H, W], full(ranges) -> occ [H, W]) on ``device``:
    the update's two parts and the whole, as ``scan_to_grid`` runs them."""
    from ..ops.kernels import scan_to_grid_cells
    from ..ops.mapping import _beam_side, _geometry_for, get_scan_to_grid

    geo = _geometry_for(spec, 0.0, device)

    def beam_side(ranges):
        return _beam_side(spec, geo, ranges.reshape(1, -1))

    def cells(prep):
        tables, endpoint = prep
        return scan_to_grid_cells(geo.base, geo.dist_m, tables, endpoint,
                                  spec.start_cell)

    return beam_side, cells, get_scan_to_grid(spec, device)


def _chains(spec, device, k):
    """The three parts as K carry-chained iterations (each iteration's
    input made from the previous iteration's output)."""
    beam_side, cells, full = split_fns(spec, device)

    def beam_chain(ranges):
        for _ in range(k):
            _, endpoint = beam_side(ranges)
            count = endpoint.sum().to(torch.float32)
            ranges = ranges + (1e-9 * count + 1e-7)
        return count

    def cells_chain(prep):
        tables, endpoint = prep
        for _ in range(k):
            occ = cells((tables, endpoint))
            # never true, but read from the grid: the next pass waits for it
            endpoint = endpoint | (occ == OCCUPIED + 10)
        return occ.sum().to(torch.float32)

    def full_chain(ranges):
        for _ in range(k):
            count = full(ranges).sum().to(torch.float32)
            ranges = ranges + (1e-9 * count + 1e-7)
        return count

    return beam_chain, cells_chain, full_chain


def main(device, spec=None, repeats: int = 3, ks=LOOP_KS):
    """The split on ``device`` (default spec: the JAX module's): each
    part's slope measured ``repeats`` times in turns (beam side, cells,
    whole update), the median kept beside every estimate; the device
    loop's K-delta with ``repeats`` repeats at K = ``ks``."""
    from .device_loop import _device_loop, measure_device_loop
    from .runner import (
        measure_throughput_slope,
        platform_name,
        resident,
        slope_variants_needed,
    )

    spec = _spec(spec)
    device = torch.device(device)
    rng = np.random.default_rng(0)
    n_var = slope_variants_needed()
    beam_side, cells, full = split_fns(spec, device)
    parts = {
        "beam_side": (beam_side, _ranges(rng, spec, repeats * n_var, device),
                      lambda o: int(o[0][0, 0, 0].item())),
        "cells": (cells, resident([beam_side(r) for r in _ranges(
            rng, spec, repeats * n_var, device)], device),
                  lambda o: int(o[0, 0, 0].item())),
        "full_update": (full, _ranges(rng, spec, repeats * n_var, device),
                        lambda o: int(o[0, 0].item())),
    }
    slopes = {name: [] for name in parts}
    for turn in range(repeats):
        for name, (fn, variants, fetch) in parts.items():
            slopes[name].append(measure_throughput_slope(
                f"Mapper_{name}", fn, variants[turn * n_var:(turn + 1) * n_var], fetch,
                sync=lambda: resident((), device))["mean_ms"])
    ms = {name: statistics.median(est) for name, est in slopes.items()}

    n_loop = 2 * repeats + 2
    loop_ranges = _ranges(rng, spec, n_loop, device)
    loop_prep = resident([beam_side(r) for r in loop_ranges], device)
    loops = {}
    for i, (name, variants) in enumerate((("beam_side", loop_ranges),
                                          ("cells", loop_prep),
                                          ("full_update", loop_ranges))):
        loops[name] = measure_device_loop(
            f"Mapper_{name}_device_loop",
            lambda k, i=i: _device_loop(_chains(spec, device, k)[i], device),
            variants, ks=ks, repeats=repeats)["p50_ms"]
    out = {
        "platform": platform_name(device),
        "beam_side_ms": ms["beam_side"],
        "cells_ms": ms["cells"],
        "full_update_ms": ms["full_update"],
        "rest_ms": ms["full_update"] - ms["cells"],
        "cells_share": ms["cells"] / ms["full_update"],
        "slope_estimates_ms": slopes,
        "device_loop_ms": {
            **loops,
            "rest": loops["full_update"] - loops["cells"],
            "cells_share": loops["cells"] / loops["full_update"],
        },
    }
    print(json.dumps(out))
    return out


def plain_update(spec, device):
    """The whole update with K5's plain version in place of the kernel."""
    from ..ops.kernels import scan_to_grid_cells_reference
    from ..ops.mapping import _geometry_for

    beam_side, _, _ = split_fns(spec, device)
    geo = _geometry_for(spec, 0.0, device)

    def run(ranges):
        tables, endpoint = beam_side(ranges)
        return scan_to_grid_cells_reference(geo.base, geo.dist_m, tables, endpoint,
                                            spec.start_cell)[0]

    return run


def shootout(device, spec=None):
    """The update through K5 against the same update through its plain
    version: checksum-equal (the whole grid, ``torch.equal``) on one
    input, then each slope-timed over distinct inputs."""
    from .runner import measure_throughput_slope, resident, slope_variants_needed

    spec = _spec(spec)
    device = torch.device(device)
    rng = np.random.default_rng(0)
    forms = {"k5": split_fns(spec, device)[2], "plain": plain_update(spec, device)}
    out, ref = {}, None
    for name, fn in forms.items():
        variants = _ranges(rng, spec, slope_variants_needed(), device)
        if ref is None:
            ref = (variants[0], fn(variants[0]))
        else:
            assert torch.equal(fn(ref[0]), ref[1]), f"{name} output differs from k5"
        out[name] = measure_throughput_slope(
            name, fn, variants, lambda o: int(o[0, 0].item()),
            sync=lambda: resident((), device))["mean_ms"]
        print(name, out[name], "ms", flush=True)
    out["checksum"] = int(ref[1].to(torch.int64).sum().item())
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import argparse

    from .runner import parse_device_args

    _parser = argparse.ArgumentParser(description=__doc__)
    _parser.add_argument("--modes", action="store_true")
    _device, _args = parse_device_args(_parser)
    shootout(_device) if _args.modes else main(_device)
