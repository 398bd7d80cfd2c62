"""Serving artifacts: a program of the port exported once, then loaded and
called in a serving process without the code that built it.

Counterpart of ``kompass_core_tpu/serving/export.py``. The JAX package
serialises the lowered StableHLO of a jitted function (``jax.export``);
here ``torch.export`` traces the program into an ``ExportedProgram``, a
graph of ATen operators and of the port's kernels as registered operators
(``kompass_torch::*``, ``ops/kernels.py``), which ``torch.export.save``
serialises. A serving process reads it back with ``torch.export.load`` and
calls the graph: no solver, fleet or controller module builds anything
there.

Artifact container format (one file), the JAX package's::

    8 bytes   magic  b"KTPUART1"
    4 bytes   little-endian u32 header length H
    H bytes   JSON header {kind, torch_version, cuda, created_unix,
              platforms, device, meta}
    rest      torch.export.save of the ExportedProgram

The header reads without torch's deserialiser (``read_artifact_header``),
so an orchestrator can inventory artifacts cheaply. ``cuda`` is the CUDA
version torch was built with (null for a CPU build), ``device`` the
device the program was traced on.

Device rule. Every export and load function takes a keyword ``device``,
which nothing defaults. ``export_*`` traces on ``device``; ``platforms``
lists the device types the artifact may be loaded on, by default
``(device.type,)``. ``load_*`` moves the program to ``device``
(``torch.export.passes.move_to_device_pass``) when it was traced on
another, and raises when ``device.type`` is not in ``platforms``. The
kernels are operators whose implementation the dispatcher picks by the
tensors' device, so an artifact traced on the CPU and served on ``cuda``
launches the kernels there, and one served on the CPU runs their plain
versions. The graph is exported without ``run_decompositions()``: the
loaded program runs the same ATen operators as the live one, so it
gives the live program's values bit for bit.

Importing this module loads no solver, fleet or controller module;
``load_artifact`` registers the kernels' operators and the fleet's
NamedTuples (``_register_fleet_pytrees``) when it first runs.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

__all__ = [
    "export_callable",
    "trace_callable",
    "trace_fleet_tick",
    "export_packed_solver",
    "export_fleet_tick",
    "export_fleet_ticks_on_device",
    "load_artifact",
    "load_packed_solver",
    "read_artifact_header",
    "shard_fleet_args",
    "sharded_fleet_call",
    "LoadedArtifact",
]

_MAGIC = b"KTPUART1"


def _as_tensor(x, device) -> torch.Tensor:
    """A leaf as a tensor on ``device``: tensors moved (no copy where they
    lie there already), numpy arrays and scalars converted."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def _on_device(tree, device):
    return pytree.tree_map(lambda x: _as_tensor(x, device), tree)


class _Program(torch.nn.Module):
    """``fn`` as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def trace_callable(fn: Callable, example_args: Tuple, *, device):
    """The ``ExportedProgram`` of ``fn(*example_args)`` traced on ``device``
    (``example_args`` as for ``export_callable``), as an artifact holds
    it: no example inputs and no stack traces. Tracing runs no kernel."""
    args = _on_device(tuple(example_args), torch.device(device))
    program = torch.export.export(_Program(fn), args, strict=False)
    # the graph's inputs keep their shapes and dtypes; the example values
    # themselves (a fleet's path tables: megabytes) and the nodes' stack
    # traces (the exporting machine's source paths) stay out of the file
    program.example_inputs = None
    for node in program.graph.nodes:
        node.meta.pop("stack_trace", None)
    return program


def export_callable(
    fn: Callable,
    example_args: Tuple,
    path: str,
    *,
    device,
    kind: str = "callable",
    meta: Optional[Dict[str, Any]] = None,
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export ``fn(*example_args)`` as a serving artifact.

    ``example_args``: tensors, numpy arrays or numbers, in any pytree of
    tuples and NamedTuples; they are moved to ``device`` and the program
    is traced there, and only their shapes and dtypes are recorded.
    ``platforms``: the device types the artifact may be loaded on
    (default ``(device.type,)``), ``device.type`` among them. Returns the
    written header dict."""
    device = torch.device(device)
    platforms = list(platforms) if platforms else [device.type]
    if device.type not in platforms:
        raise ValueError(f"traced on {device.type}, which platforms {platforms} "
                         "does not list")
    program = trace_callable(fn, example_args, device=device)
    payload = io.BytesIO()
    torch.export.save(program, payload)

    header = {
        "kind": kind,
        "torch_version": torch.__version__,
        "cuda": torch.version.cuda,
        "created_unix": time.time(),
        "platforms": platforms,
        "device": str(device),
        "meta": meta or {},
    }
    blob = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(blob)))
        f.write(blob)
        f.write(payload.getvalue())
    return header


def _read_header_from(f, path: str) -> Dict[str, Any]:
    """Parse the container prefix (magic + u32 length + JSON header),
    leaving ``f`` at the payload: the one place that knows the on-disk
    format."""
    magic = f.read(8)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not a kompass_core_tpu_torch artifact")
    (hlen,) = struct.unpack("<I", f.read(4))
    return json.loads(f.read(hlen).decode("utf-8"))


def read_artifact_header(path: str) -> Dict[str, Any]:
    """Read the JSON header only (no torch deserialisation)."""
    with open(path, "rb") as f:
        return _read_header_from(f, path)


@dataclasses.dataclass
class LoadedArtifact:
    """A loaded serving artifact. ``call`` runs the program on ``device``
    (numpy arrays and numbers among its arguments are copied there first);
    ``program`` is the ``ExportedProgram``."""

    header: Dict[str, Any]
    call: Callable
    device: Optional[torch.device] = None
    program: Any = None
    _moved: Dict[torch.device, "LoadedArtifact"] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def kind(self) -> str:
        return self.header["kind"]

    @property
    def meta(self) -> Dict[str, Any]:
        return self.header["meta"]

    def on(self, device) -> "LoadedArtifact":
        """This artifact on ``device`` (itself where it lies there already;
        else the program moved there once and kept)."""
        device = torch.device(device)
        if device == self.device:
            return self
        if device not in self._moved:
            self._moved[device] = _loaded(self.header, self.program, device)
        return self._moved[device]


def _check_platform(header: Dict[str, Any], device: torch.device, path) -> None:
    if "torch_version" not in header:
        raise ValueError(
            f"{path}: a kompass_core_tpu (JAX) artifact "
            f"(jax_version {header.get('jax_version')}); re-export it with "
            "kompass_core_tpu_torch.serving"
        )
    if device.type not in header["platforms"]:
        raise ValueError(
            f"{path}: exported for {header['platforms']}, not for "
            f"{device.type}; re-export it with platforms naming {device.type!r}"
        )


def _loaded(header, program, device) -> LoadedArtifact:
    """The artifact with ``program`` moved to ``device`` where it was
    traced on another."""
    from torch.export.passes import move_to_device_pass

    if torch.device(header["device"]) != device:
        program = move_to_device_pass(program, device)
    module = program.module()

    def call(*args):
        return module(*pytree.tree_map(
            lambda x: x if isinstance(x, torch.Tensor) else _as_tensor(x, device),
            args))

    return LoadedArtifact(header=header, call=call, device=device, program=program)


def load_artifact(path: str, *, device) -> LoadedArtifact:
    """Load an artifact to be served on ``device``; raises for a JAX
    package artifact and for a device type its ``platforms`` do not
    list."""
    device = torch.device(device)
    with open(path, "rb") as f:
        header = _read_header_from(f, path)
        _check_platform(header, device, path)
        payload = f.read()
    classes = _register_fleet_pytrees()
    with torch.serialization.safe_globals(classes):
        program = torch.export.load(io.BytesIO(payload))
    return _loaded(header, program, device)


# ---------------------------------------------------------------------------
# Framework-specific entry points
# ---------------------------------------------------------------------------


def export_packed_solver(
    spec,
    path: str,
    *,
    device,
    custom_costs: Sequence = (),
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export the packed single-buffer DWA solver for ``spec``.

    The artifact's calling convention is one f32 ``[packed_input_size]``
    buffer in, one packed output vector out: the live solver's
    single-transfer contract (``ops/solver.py`` packed interface). The
    whole ``SolverSpec`` is recorded in the header, so the loader rebuilds
    it for ``pack_solver_input`` / ``unpack_solver_output``."""
    from ..ops.solver import make_packed_dwa_solver, packed_input_size

    fn = make_packed_dwa_solver(spec, device, custom_costs=custom_costs)
    buf = torch.zeros(packed_input_size(spec), dtype=torch.float32)
    meta = {"solver_spec": dataclasses.asdict(spec)}
    return export_callable(
        fn, (buf,), path, device=device, kind="packed_dwa_solver", meta=meta,
        platforms=platforms,
    )


def load_packed_solver(path: str, *, device):
    """Load a ``packed_dwa_solver`` artifact onto ``device``.

    Returns ``(artifact, spec)``: ``artifact.call(buf)`` runs the solve;
    ``spec`` is the rebuilt ``SolverSpec``."""
    from ..ops.solver import SolverSpec

    art = load_artifact(path, device=device)
    if art.kind != "packed_dwa_solver":
        raise ValueError(f"{path}: artifact kind {art.kind!r}, expected "
                         "'packed_dwa_solver'")
    d = dict(art.meta["solver_spec"])
    if d.get("collision_box") is not None:
        d["collision_box"] = tuple(d["collision_box"])
    return art, SolverSpec(**d)


_FLEET_PYTREES: List[type] = []


def _register_fleet_pytrees() -> List[type]:
    """Register the fleet's NamedTuples with torch's pytree serialisation,
    so a tick program's calling convention saves and loads, and return
    them (the classes a load may unpickle). Importing the fleet solver
    registers the kernels' operators too. The names are stable: they are
    part of the artifact format; renaming one breaks old artifacts."""
    if not _FLEET_PYTREES:
        from ..ops import fleet_solver as fs

        for cls in (fs.FleetPaths, fs.FleetCarry, fs.FleetConfig,
                    fs.FleetSafety):
            pytree._register_namedtuple(
                cls, serialized_type_name=f"kompass_core_tpu_torch.{cls.__name__}"
            )
            _FLEET_PYTREES.append(cls)
    return list(_FLEET_PYTREES)


def _safety(fleet) -> bool:
    return fleet._safety_cfgs is not None


def export_fleet_tick(
    fleet,
    path: str,
    *,
    device,
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export a ``DeviceFleet``'s tick program, traced on ``device``.

    The artifact takes the fleet's ``tick_example_args`` convention:
    ``(paths, cfg, carry, angles, inputs[, safety])``, with the packed
    per-tick input matrix ``[N, 4+3+R (+ 4*tracked_obstacles)]``, and
    returns ``(carry', outputs[N, len(OUT_FIELDS)])``: the live
    ``DeviceFleet.tick`` device program, minus the host-side pack and
    unpack. The header's meta records ``tracked_obstacles`` so a
    consumer sizing its input matrix from the header alone gets the
    right width."""
    return export_callable(
        _fleet_tick_program(fleet, device), fleet.tick_example_args(), path,
        device=device, kind="fleet_tick", meta=_fleet_meta(fleet),
        platforms=platforms,
    )


def _fleet_tick_program(fleet, device):
    from ..ops.fleet_solver import make_fleet_tick

    _register_fleet_pytrees()
    _check_exportable_fleet(fleet)
    return make_fleet_tick(fleet.spec, device, peer_cfg=fleet._peer_cfg,
                           safety=_safety(fleet))


def trace_fleet_tick(fleet, *, device):
    """The ``ExportedProgram`` that ``export_fleet_tick`` writes, traced on
    ``device`` and returned instead of written (``trace_callable``)."""
    return trace_callable(_fleet_tick_program(fleet, device),
                          fleet.tick_example_args(), device=device)


def _fleet_meta(fleet) -> Dict[str, Any]:
    return {
        "n_robots": int(fleet._n),
        "scan_rays": int(fleet._scan_rays),
        "safety": fleet._safety is not None,
        "tracked_obstacles": int(getattr(fleet, "_tracked", 0)),
        # rows interact in a peer-avoidance program: recorded so
        # sharded_fleet_call can refuse to row-chunk it (shard-local
        # avoidance would silently drive cross-shard robots through
        # each other)
        "peer_avoidance": getattr(fleet, "_peer_cfg", None) is not None,
    }


def export_fleet_ticks_on_device(
    fleet,
    k: int,
    path: str,
    *,
    device,
    platforms: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Export the k-tick program (``make_fleet_ticks_on_device``, the loop
    ``DeviceFleet.run_ticks_on_device`` replays as a CUDA graph), traced on
    ``device``: the tick artifact's calling convention, returning
    ``(carry', outputs[N, k, F], final_states[N, 4])``, k carry-chained
    control ticks per call. The served call runs the k ticks eagerly."""
    from ..ops.fleet_solver import make_fleet_ticks_on_device

    _register_fleet_pytrees()
    _check_exportable_fleet(fleet)
    fn = make_fleet_ticks_on_device(
        fleet.spec, k, device, peer_cfg=fleet._peer_cfg, safety=_safety(fleet),
    )
    meta = dict(_fleet_meta(fleet), k_ticks=int(k))
    return export_callable(
        fn, fleet.tick_example_args(), path, device=device,
        kind="fleet_ticks_on_device", meta=meta, platforms=platforms,
    )


def _check_exportable_fleet(fleet) -> None:
    """A mesh-sharded fleet's program would carry its device placement,
    the wrong contract for a shippable artifact: export the one-device
    program and shard at the serving site with ``sharded_fleet_call``."""
    if getattr(fleet, "mesh", None) is not None:
        raise NotImplementedError(
            "export of mesh-sharded fleet programs is not supported: "
            "build the fleet without a mesh for export, and shard at the "
            "serving site with serving.sharded_fleet_call"
        )


def sharded_fleet_call(art: LoadedArtifact, args, devices, shards=None):
    """Serve a one-device fleet artifact across ``devices`` (a list of
    ``torch.device``s, the same one more than once allowed).

    The fleet tick is row-local per robot, so serving many devices needs
    no sharded program: every [N, ...] leaf of ``args`` is cut into
    ``len(devices)`` shards of the artifact's exported row count, shard d
    goes to ``devices[d]``, and the artifact (moved to each device once,
    ``LoadedArtifact.on``) is called once per shard; launches are
    asynchronous, so shards on different cards run at once. The outputs
    are concatenated on the host (numpy) in fleet row order: the
    monolithic call's values bit for bit.

    ``args``: the whole fleet's arguments in the artifact's calling
    convention (``DeviceFleet.tick_example_args`` of a fleet built with
    ``len(devices) * art.meta['n_robots']`` robots and the same
    construction parameters). Peer-avoidance programs are refused: their
    rows interact, and shard-local avoidance would silently drive
    cross-shard robots through each other. So is an artifact without the
    ``peer_avoidance`` marker, which cannot prove its rows independent.

    A serving loop calls ``shard_fleet_args`` once and passes the result
    as ``shards``: the static tables then move once, not per call."""
    peer = art.meta.get("peer_avoidance")
    if peer is None:
        raise ValueError(
            "artifact header has no 'peer_avoidance' field (exported by "
            "an older build): cannot prove its rows don't interact, so "
            "row-chunked serving is refused; re-export with the current "
            "build, or serve the artifact whole on one device"
        )
    if peer:
        raise ValueError(
            "this artifact was exported from a peer-avoidance fleet: "
            "its rows interact, so row-chunked serving would give "
            "shard-local-only avoidance; serve it whole on one device"
        )
    if shards is None:
        shards = shard_fleet_args(art, args, devices)
    outs = [art.on(dev).call(*shard) for dev, shard in zip(devices, shards)]
    return pytree.tree_map(
        lambda *xs: np.concatenate([x.cpu().numpy() for x in xs], axis=0), *outs)


def shard_fleet_args(art: LoadedArtifact, args, devices):
    """Cut the whole fleet's arguments into one [n_exp, ...] tree per
    device, each shard a copy of its own there."""
    n_exp = int(art.meta["n_robots"])
    n_tot = int(pytree.tree_leaves(args)[0].shape[0])
    if n_tot != n_exp * len(devices):
        raise ValueError(
            f"args carry {n_tot} fleet rows; the artifact serves "
            f"{n_exp} rows per call, so {len(devices)} devices need "
            f"exactly {n_exp * len(devices)}"
        )

    def cut(a, d, dev):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        return a[d * n_exp:(d + 1) * n_exp].to(dev, copy=True)

    return [pytree.tree_map(lambda a, _d=d, _dev=dev: cut(a, _d, _dev), args)
            for d, dev in enumerate(devices)]
