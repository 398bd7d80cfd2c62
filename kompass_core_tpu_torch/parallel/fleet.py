"""Scenario-batched fleet solving: many robots' packed solver inputs in
one call.

Counterpart of ``kompass_core_tpu/parallel/fleet.py``. A batch of
independent robot scenarios (one ``pack_solver_input`` buffer each, the
JAX package's layout) is solved on one device: the rows go to the device
in one copy and every chunk of rows is one ``dwa_solve`` over a robot
axis, so each chunk launches its backend's sweep kernel once (twice for
``"pallas_v1"``). The JAX package ``vmap``s a one-robot solve and
dispatches it in chunks of 64 rows; here the robot axis is a plain batch
dimension, and ``chunk_size`` keeps the JAX meaning: rows per dispatch.

Not ported yet: the device mesh (scenario sharding across cards) and the
sample-parallel solve, both ROADMAP queue 1 item 1; they raise
``NotImplementedError``.
"""

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.solver import (
    SolverSpec,
    _reject_dynamic_box,
    _unpack_and_solve,
    pack_solver_input,
    packed_input_size,
)


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to kompass_core_tpu_torch yet "
        "(ROADMAP queue 1, item 1: scale-out over torch.distributed)"
    )


def make_fleet_solver(
    spec: SolverSpec,
    device,
    mesh=None,
    custom_costs: Sequence = (),
    chunk_size: Optional[int] = 64,
):
    """Batched solver on ``device``: f32[N, packed_input_size] (numpy or
    tensor) -> f32[N, out_size] tensor on ``device``.

    The whole input goes to the device in one copy. With ``chunk_size``
    the rows are solved in dispatches of that many robots, the tail
    padded with zero rows (they solve to found=False and are sliced off);
    ``None`` solves all rows in one dispatch. Nothing waits for the
    device: the caller's read of the output is the one sync."""
    if mesh is not None:
        _not_ported("make_fleet_solver(mesh=...)")
    _reject_dynamic_box(spec, "fleet solver")
    device = torch.device(device)
    size = packed_input_size(spec)
    custom_costs = tuple(custom_costs)

    def solve(bufs):
        bufs = torch.as_tensor(bufs, dtype=torch.float32, device=device)
        if bufs.dim() != 2 or bufs.shape[1] != size:
            raise ValueError(
                f"fleet input must be [N, {size}], got {list(bufs.shape)}"
            )
        n = bufs.shape[0]
        if not chunk_size or n <= chunk_size:
            return _unpack_and_solve(spec, bufs, custom_costs)
        pad = (-n) % chunk_size
        if pad:
            bufs = torch.cat([bufs, bufs.new_zeros(pad, size)])
        outs = [_unpack_and_solve(spec, bufs[i : i + chunk_size], custom_costs)
                for i in range(0, n + pad, chunk_size)]
        return torch.cat(outs)[:n]

    return solve


def make_sample_parallel_solver(spec: SolverSpec, mesh, axis_name: str = "sp"):
    """One robot's sample axis split across cards, with a lowest-cost,
    lowest-rank combine: not ported yet (ROADMAP queue 1, item 1)."""
    _not_ported("make_sample_parallel_solver")


class FleetPlanner:
    """N robot scenarios on one device: the host keeps the [N, L] packed
    input matrix, ``set_scenario`` fills one robot's row, and ``step``
    copies the matrix to the device once and returns the [N, out] result
    matrix on the host."""

    def __init__(self, spec: SolverSpec, num_robots: int, device, mesh=None):
        self.spec = spec
        self.num_robots = num_robots
        self.mesh = mesh
        self.solver = make_fleet_solver(spec, device, mesh)
        self.inputs = np.zeros((num_robots, packed_input_size(spec)),
                               dtype=np.float32)

    def set_scenario(self, robot_index: int, **kwargs):
        """Fill one robot's packed input row (``pack_solver_input``'s
        arguments but ``spec`` and ``buf``)."""
        if not 0 <= robot_index < self.num_robots:
            raise IndexError(
                f"robot_index {robot_index} out of range for a "
                f"{self.num_robots}-robot fleet"
            )
        pack_solver_input(self.spec, self.inputs[robot_index], **kwargs)

    def step(self) -> np.ndarray:
        return self.solver(self.inputs).cpu().numpy()[: self.num_robots]
