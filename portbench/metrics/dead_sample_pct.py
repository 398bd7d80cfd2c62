"""Device step: the share of the robot-samples the fleet rolls out that
a robot's own kinematics rule out before any obstacle test (the
program's ``fleet.dead_samples`` counter over its ``fleet.samples``
counter): a non-omni robot's vy slots past the first in an omni-shaped
grid. The program counts them while its spans are on, so over the
traced calls. It sizes what a grid per drive could save."""

from portbench.program_spans import totals


def read(tr):
    t = totals()
    samples = t.get("fleet.samples", {}).get("count", 0)
    if not samples:
        return None
    return 100.0 * t.get("fleet.dead_samples", {}).get("count", 0) / samples
