"""Capture of a function as one CUDA graph, shared by the fleet's tick and
k-tick loop (``parallel/fleet_v2.py``) and the planners' scans
(``planning/_scan.py``)."""

from typing import Callable, Optional

import torch


def capture(fn: Callable, device, warmup: Optional[Callable] = None):
    """(graph, what ``fn()`` returned while captured): ``fn`` captured on
    ``device`` as one CUDA graph, after ``warmup`` (default ``fn``) ran
    once eagerly on a side stream, which PyTorch's graph capture requires.
    The graph replays on the tensors ``fn`` read and wrote; a capture that
    fails raises."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        (warmup or fn)()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out
