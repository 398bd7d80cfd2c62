"""Host front end: kernel and graph launch API calls per control tick
(``cudaLaunchKernel``, ``cudaGraphLaunch`` and their driver forms in the
profiler's runtime events), over the traced calls."""


def read(tr):
    ticks = tr.counts.get("ticks", 0)
    if not ticks or not tr.launches:
        return None
    return tr.launches / ticks
