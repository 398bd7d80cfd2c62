"""Device step: device time per control tick of the follower and the
gate (the program's ``step.follow`` and ``step.gate`` stages, timed by
CUDA events: goal, target, horizon, obstacle rows, segment window, peer
rows; overrides, safety, outputs, the k-tick state update)."""

from portbench.program_spans import per_tick


def read(tr):
    return per_tick(tr, ("step.follow", "step.gate"), "device_s")
