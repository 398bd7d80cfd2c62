"""Device step: device time per control tick of admissibility,
truncation, the weighted costs and the winner (the program's
``solve.costs`` stage, timed by CUDA events)."""

from portbench.program_spans import per_tick


def read(tr):
    return per_tick(tr, ("solve.costs",), "device_s")
