"""Device step: device time per control tick of every kernel that is not
a sweep kernel (the rollout, costs, admissibility, argmin, follower,
peers and safety as PyTorch operations)."""

from portbench.roofline import is_sweep


def read(tr):
    ms = sum(d for name, _, d in tr.kernels if not is_sweep(name)) * 1e-3
    ticks = tr.counts.get("ticks", 0)
    if not ticks or not ms:
        return None
    return ms / ticks
