"""Kernels: device time per control tick of the sweep kernels, by name
(``roofline.SWEEP_KERNELS``)."""

from portbench.roofline import is_sweep


def read(tr):
    ms = sum(d for name, _, d in tr.kernels if is_sweep(name)) * 1e-3
    ticks = tr.counts.get("ticks", 0)
    if not ticks or not ms:
        return None
    return ms / ticks
