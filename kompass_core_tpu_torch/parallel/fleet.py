"""Scenario-batched fleet solving: many robots' packed solver inputs in
one call, on one device or sharded over a mesh.

Counterpart of ``kompass_core_tpu/parallel/fleet.py``. A batch of
independent robot scenarios (one ``pack_solver_input`` buffer each, the
JAX package's layout) is solved on one device: the rows go to the device
in one copy and every chunk of rows is one ``dwa_solve`` over a robot
axis, so each chunk launches its backend's sweep kernel once (twice for
``"pallas_v1"``). The JAX package ``vmap``s a one-robot solve and
dispatches it in chunks of 64 rows; here the robot axis is a plain batch
dimension, and ``chunk_size`` keeps the JAX meaning: rows per dispatch.

Two scale-out forms over a ``FleetMesh`` (``parallel/multihost.py``):

1. **Fleet data-parallel** (``make_fleet_solver(mesh=...)``): each shard
   solves its own rows on its device in chunks of ``chunk_size``, with no
   collective. The input is this process's rows; the output one tensor
   per local shard.
2. **Sample-parallel** (``make_sample_parallel_solver``): one robot's
   sample axis split over the shards (each shard's packed input carries
   its own slice of the velocity window), combined by the lowest cost
   with the lowest global shard index on a tie, as the JAX package's
   ``pmin`` pair does; the winner's output reaches every shard as the
   masked sum of JAX's ``psum``.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.fleet_solver import check_target
from ..ops.solver import (
    SolverSpec,
    _reject_dynamic_box,
    _unpack_and_solve,
    pack_solver_input,
    packed_input_size,
)


def _solve_chunks(spec: SolverSpec, bufs, chunk_size, custom_costs):
    """[n, L] rows on one device solved in dispatches of ``chunk_size``
    rows, the tail padded with zero rows (they solve to found=False and
    are sliced off); ``None`` solves all rows in one dispatch."""
    n = bufs.shape[0]
    if not chunk_size or n <= chunk_size:
        return _unpack_and_solve(spec, bufs, custom_costs)
    pad = (-n) % chunk_size
    if pad:
        bufs = torch.cat([bufs, bufs.new_zeros(pad, bufs.shape[1])])
    outs = [_unpack_and_solve(spec, bufs[i : i + chunk_size], custom_costs)
            for i in range(0, n + pad, chunk_size)]
    return torch.cat(outs)[:n]


def _check_rows(bufs, size):
    if bufs.ndim != 2 or bufs.shape[1] != size:
        raise ValueError(
            f"fleet input must be [N, {size}], got {list(bufs.shape)}"
        )


def make_fleet_solver(
    spec: SolverSpec,
    device=None,
    mesh=None,
    custom_costs: Sequence = (),
    chunk_size: Optional[int] = 64,
):
    """Batched solver: f32[N, packed_input_size] (numpy or tensor) ->
    f32[N, out_size], on ``device`` or over ``mesh`` (exactly one).

    On a device the whole input goes there in one copy and the result is
    one tensor there. Over a mesh the input is this process's rows (the
    whole fleet in one process), N a multiple of its local shards; each
    shard's rows are copied to its device and solved there, and the
    result is a list of one [N / shards, out_size] tensor per local shard
    (``FleetMesh.host_rows`` joins them). With ``chunk_size`` each device
    solves its rows in dispatches of that many robots. Nothing waits for
    the device: the caller's read of the output is the one sync."""
    check_target(device, mesh, "make_fleet_solver")
    _reject_dynamic_box(spec, "fleet solver")
    size = packed_input_size(spec)
    custom_costs = tuple(custom_costs)
    if mesh is not None:
        def solve_sharded(bufs):
            _check_rows(bufs, size)
            return [_solve_chunks(spec, part.to(torch.float32), chunk_size,
                                  custom_costs)
                    for part in mesh.split(bufs)]

        return solve_sharded
    device = torch.device(device)

    def solve(bufs):
        bufs = torch.as_tensor(bufs, dtype=torch.float32, device=device)
        _check_rows(bufs, size)
        return _solve_chunks(spec, bufs, chunk_size, custom_costs)

    return solve


def make_sample_parallel_solver(spec: SolverSpec, mesh):
    """One scenario's solve with the sample axis split over ``mesh``'s
    shards: f32[local shards, packed_input_size] (row d is local shard
    d's input, whose velocity window covers that shard's slice of the
    global sample grid) -> one [1, out_size] tensor per local shard, each
    the globally winning shard's packed output.

    The combine is three ``all_reduce`` calls: the min of the shards'
    winning costs, the min of the global shard indices that hold it, and
    the sum of the outputs masked to the winner's (a sum, as JAX's
    ``psum``: a -0.0 of the winner comes out +0.0)."""
    _reject_dynamic_box(spec, "sample-parallel solver")
    size = packed_input_size(spec)

    def solve(bufs):
        _check_rows(bufs, size)
        outs = [_unpack_and_solve(spec, part.to(torch.float32))
                for part in mesh.split(bufs)]
        # out[:, 1] is the shard's winning cost (inf if it has no admissible
        # sample)
        costs = [o[:, 1] for o in outs]
        best = mesh.all_reduce(costs, "min")
        ranks = [torch.where(c == b, mesh.shard_index(d), mesh.size).to(torch.int32)
                 for d, (c, b) in enumerate(zip(costs, best))]
        winner = mesh.all_reduce(ranks, "min")
        contrib = [torch.where((w == mesh.shard_index(d))[:, None], o, 0.0)
                   for d, (o, w) in enumerate(zip(outs, winner))]
        return mesh.all_reduce(contrib, "sum")

    return solve


class FleetPlanner:
    """N robot scenarios on ``device`` or over a one-process ``mesh``: the
    host keeps the [N, L] packed input matrix (N padded to a multiple of
    the mesh size; pad rows stay zero and solve to found=False),
    ``set_scenario`` fills one robot's row, and ``step`` solves the
    matrix and returns the robots' [num_robots, out] results on the
    host."""

    def __init__(self, spec: SolverSpec, num_robots: int, device=None, mesh=None):
        if mesh is not None and mesh.multiprocess:
            raise ValueError(
                "FleetPlanner holds every robot's row in one process: give "
                "it a mesh of this process's devices"
            )
        self.spec = spec
        self.num_robots = num_robots
        self.mesh = mesh
        self.solver = make_fleet_solver(spec, device, mesh)
        n_dev = mesh.size if mesh is not None else 1
        self._n_rows = -(-num_robots // n_dev) * n_dev
        self.inputs = np.zeros((self._n_rows, packed_input_size(spec)),
                               dtype=np.float32)

    def set_scenario(self, robot_index: int, **kwargs):
        """Fill one robot's packed input row (``pack_solver_input``'s
        arguments but ``spec`` and ``buf``)."""
        # a pad row's result is discarded by step(): writing one is an error
        if not 0 <= robot_index < self.num_robots:
            raise IndexError(
                f"robot_index {robot_index} out of range for a "
                f"{self.num_robots}-robot fleet"
            )
        pack_solver_input(self.spec, self.inputs[robot_index], **kwargs)

    def step(self) -> np.ndarray:
        out = self.solver(self.inputs)
        if self.mesh is not None:
            return self.mesh.host_rows(out)[: self.num_robots]
        return out.cpu().numpy()[: self.num_robots]
