"""Device step: device time per control tick of the velocity grid and
the rollout (the program's ``solve.rollout`` stage, timed by CUDA
events)."""

from portbench.program_spans import per_tick


def read(tr):
    return per_tick(tr, ("solve.rollout",), "device_s")
