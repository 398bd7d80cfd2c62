"""Kernels: the sweeps' least time by ``portbench/roofline.py`` (the
function's operations and bytes at the traced ticks' active steps, at
the card's published peaks) as a share of their measured device time."""

from portbench.roofline import is_sweep, least_seconds, tick_work


def read(tr):
    measured = sum(d for name, _, d in tr.kernels if is_sweep(name)) * 1e-6
    steps = tr.counts.get("active_steps", 0)
    if not measured or not steps or "samples" not in tr.work:
        return None
    least = sum(least_seconds(ops, nbytes) for ops, nbytes in
                tick_work(tr.work, tr.counts["robot_ticks"], steps))
    return 100.0 * least / measured
