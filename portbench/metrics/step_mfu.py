"""Device step: the whole step's share of the card's FP32 peak: the
function's counted operations of every traced tick (the sweeps'; the
O(samples x steps) rest is not counted) over the device's busy time at
67e12 operations per second. It bounds the sweeps' roofline from above
for a change that takes a sweep off the device path."""

from portbench.roofline import FP32_PEAK, tick_work


def read(tr):
    steps = tr.counts.get("active_steps", 0)
    if not tr.busy_s or not steps or "samples" not in tr.work:
        return None
    ops = sum(o for o, _ in tick_work(tr.work, tr.counts["robot_ticks"], steps))
    return 100.0 * ops / (tr.busy_s * FP32_PEAK)
