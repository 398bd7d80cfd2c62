"""Fixed-capacity scans: the counterpart of the JAX package's ``lax.scan``.

A planner core is a body ``carry = body(carry, consts, i, draw)`` run a
fixed number of times over tensors of static shape: ``carry`` a tuple of
tensors, ``consts`` a dict of tensors the body reads and never writes
(the grid, the problem's scalars), ``i`` the iteration's index as a 0-d
int64 tensor and ``draw`` the iteration's row of each per-iteration
random input. A body reads tensors through its arguments alone: a
captured graph replays on the static copies of them.

``run_scan`` runs that loop eagerly on the CPU. On a CUDA device it
captures ``chunk`` iterations as one CUDA graph, once per (core, static
shapes, chunk length), and replays it per chunk after copying the
chunk's carry, index and draws into the graph's static buffers: the
counterpart of the JAX package's one compiled scan, so the host enqueues
one graph instead of a chunk's thousands of kernels. A last chunk shorter
than ``chunk`` gets a graph of its own length (padding it would grow the
tree), and a capture that fails raises.

Draws are inputs, never made inside a body: ``GeneratorDraws`` makes
them chunk by chunk from CPU ``torch.Generator`` streams, one per field,
so a chunk's values do not depend on how the iterations were chunked
and a seed gives the same draws on every device.
"""

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels import _sqrt
from ..utils.cuda_graph import capture

# ``graphs=EAGER`` runs the eager loop on a CUDA device too (the reference
# the graph replay is held against)
EAGER = "eager"


@dataclasses.dataclass
class ScanGraph:
    """One captured chunk: the graph and the static tensors it reads
    (``carry``, ``consts``, ``index``, ``draws``) and writes (``out``)."""

    graph: "torch.cuda.CUDAGraph"
    carry: Tuple[torch.Tensor, ...]
    consts: Dict[str, torch.Tensor]
    index: torch.Tensor
    draws: Tuple[torch.Tensor, ...]
    out: Tuple[torch.Tensor, ...]


def _draw_source(draws):
    """(start, stop) -> tuple of [stop - start, ...] tensors."""
    if draws is None:
        return lambda start, stop: ()
    if callable(draws):
        return draws
    full = tuple(draws)
    return lambda start, stop: tuple(d[start:stop] for d in full)


def _run_chunk(body, carry, consts, index, draws):
    for j in range(index.shape[0]):
        carry = body(carry, consts, index[j], tuple(d[j] for d in draws))
    return carry


def _signature(tensors):
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _const_signature(consts):
    return tuple((k, tuple(t.shape), t.dtype) for k, t in consts.items())


def _capture(body, carry, consts, index, draws) -> ScanGraph:
    """Capture one chunk of ``body`` on static copies of its inputs (the
    side stream's warm-up runs one iteration)."""
    device = index.device
    static = ScanGraph(None, tuple(c.clone() for c in carry),
                       {k: c.clone() for k, c in consts.items()}, index.clone(),
                       tuple(d.to(device, copy=True) for d in draws), ())
    static.graph, static.out = capture(
        lambda: _run_chunk(body, static.carry, static.consts, static.index,
                           static.draws),
        device,
        warmup=lambda: _run_chunk(body, static.carry, static.consts,
                                  static.index[:1],
                                  tuple(d[:1] for d in static.draws)))
    return static


def run_scan(body: Callable, carry: Sequence[torch.Tensor], draws=None, *,
             iterations: int, chunk: int,
             consts: Optional[Dict[str, torch.Tensor]] = None,
             graphs=None, key=None) -> Tuple[torch.Tensor, ...]:
    """``carry`` after ``iterations`` runs of ``body`` (see the module's
    docstring). ``draws``: None, a tuple of [iterations, ...] tensors, or
    a callable (start, stop) -> the tuple of those rows. On a CUDA device
    ``graphs`` is the cache of captured chunks (a dict, kept by the
    caller across calls; None captures afresh) keyed by ``key`` (the
    core and its static arguments) and the shapes, or ``EAGER``. The loop
    runs in inference mode (a body's many small operations skip autograd's
    bookkeeping), and what it returns are ordinary tensors."""
    with torch.inference_mode():
        carry = _scan(body, tuple(carry), draws, int(iterations), chunk,
                      dict(consts or {}), graphs, key)
    return tuple(c.clone() for c in carry)


def _scan(body, carry, draws, iterations, chunk, consts, graphs, key):
    chunk = max(1, min(int(chunk), iterations)) if iterations > 0 else 1
    source = _draw_source(draws)
    device = carry[0].device
    replay = device.type == "cuda" and graphs is not EAGER
    if replay and graphs is None:
        graphs = {}
    for start in range(0, iterations, chunk):
        stop = min(start + chunk, iterations)
        index = torch.arange(start, stop, device=device)
        rows = source(start, stop)
        if not replay:
            carry = _run_chunk(body, carry, consts, index,
                               tuple(d.to(device) for d in rows))
            continue
        cache_key = (key, stop - start, _signature(carry),
                     _const_signature(consts), _signature(rows))
        g = graphs.get(cache_key)
        if g is None:
            g = graphs[cache_key] = _capture(body, carry, consts, index, rows)
        for static, value in zip(g.carry, carry):
            static.copy_(value)
        for name, value in consts.items():
            g.consts[name].copy_(value)
        g.index.copy_(index)
        for static, value in zip(g.draws, rows):
            static.copy_(value)
        g.graph.replay()
        carry = g.out
    return carry


# --- draws --------------------------------------------------------------------

_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class Field:
    """One per-iteration random input: ``kind`` is "uniform" (one value in
    [0, 1)), "box" (a point uniform in [lo, hi), shape (2,)) or
    "gumbel" (``shape`` standard Gumbel values)."""

    name: str
    kind: str
    shape: Tuple[int, ...] = ()


def uniform01(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32)


def uniform_box(gen: torch.Generator, rows: int, lo, hi) -> torch.Tensor:
    """[rows, 2] points uniform in [lo, hi): ``jax.random.uniform``'s
    scaling, ``max(lo, u * (hi - lo) + lo)``, in float32."""
    lo = torch.as_tensor(lo, dtype=torch.float32)
    hi = torch.as_tensor(hi, dtype=torch.float32)
    return torch.maximum(lo, uniform01(gen, (rows, 2)) * (hi - lo) + lo)


def gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel values, ``-log(-log(u))`` with u in [tiny, 1) as
    ``jax.random.gumbel`` draws them."""
    u = torch.clamp(uniform01(gen, shape), min=_TINY)
    return -torch.log(-torch.log(u))


class GeneratorDraws:
    """The draws of ``fields`` for iterations [start, stop), asked for in
    order: each field from its own CPU generator seeded from ``seed`` and
    the field's position (torch's CPU generator fills a tensor in order,
    so the values do not depend on the chunking)."""

    def __init__(self, seed: int, fields: Sequence[Field], lo=None, hi=None):
        self._fields = tuple(fields)
        self._gens = [torch.Generator().manual_seed(_field_seed(seed, j))
                      for j in range(len(self._fields))]
        self._lo, self._hi = lo, hi
        self._next = 0

    def __call__(self, start: int, stop: int):
        if start != self._next:
            raise ValueError(f"draws asked for from {start}, next is {self._next}")
        self._next = stop
        rows = stop - start
        out = []
        for f, g in zip(self._fields, self._gens):
            if f.kind == "uniform":
                out.append(uniform01(g, (rows,) + f.shape))
            elif f.kind == "box":
                out.append(uniform_box(g, rows, self._lo, self._hi))
            elif f.kind == "gumbel":
                out.append(gumbel(g, (rows,) + f.shape))
            else:
                raise ValueError(f"unknown draw kind {f.kind!r}")
        return tuple(out)


def _field_seed(seed: int, j: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * j + 1) % (1 << 63)


def seeded_generator(seed: int, stream: int = 0) -> torch.Generator:
    """A CPU generator for a solver's non-iteration draws (roadmap samples)."""
    return torch.Generator().manual_seed(_field_seed(seed, 1000 + stream))


__all__ = ["EAGER", "Field", "GeneratorDraws", "ScanGraph", "run_scan",
           "uniform01", "uniform_box", "gumbel", "seeded_generator"]


# --- body helpers -------------------------------------------------------------
# index reads and writes through explicit index ops: a 0-d index tensor
# never becomes a host integer (which would sync, and break a capture)


def take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor i (a row of x)."""
    return x.index_select(0, i.reshape(1).long()).squeeze(0)


def put(x: torch.Tensor, i: torch.Tensor, v, ok=None) -> torch.Tensor:
    """``x.at[i].set(v)``, kept only where ``ok`` (0-d bool) holds: the
    JAX package's ``jnp.where(ok, x.at[i].set(v), x)``."""
    row = (1,) + x.shape[1:]
    if isinstance(v, torch.Tensor):
        v = v.to(x.dtype).reshape(row)
    else:  # a fill, not a host-to-device copy (which a capture refuses)
        v = torch.full(row, v, dtype=x.dtype, device=x.device)
    new = x.index_copy(0, i.reshape(1).long(), v)
    return new if ok is None else torch.where(ok, new, x)


def norm(v: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(v, axis=-1)`` of [..., 2] float32 vectors: the sum
    of squares, then a correctly rounded root (``ops.kernels._sqrt``)."""
    sx, sy = (v * v).unbind(-1)
    return _sqrt(sx + sy)


def f64(fn, *xs) -> torch.Tensor:
    """``fn`` (cos, sin, atan2, log, log1p, exp) in float64, rounded to
    float32: PyTorch's CPU and CUDA float32 implementations differ by an
    ulp now and then, and one such ulp in a node can split a tree later;
    through float64 every device rounds the same, as ``_sqrt`` does for
    the root."""
    return fn(*(x.double() for x in xs)).float()


def scalar(x, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``: a scalar argument as the JAX
    package receives it (``jnp.float32(x)``)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(())
    return torch.tensor(float(np.float32(x)), dtype=torch.float32, device=device)


def vec(x, device, dtype=torch.float32) -> torch.Tensor:
    """An array argument as a tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)
