"""Production serving: export and load of hermetic program artifacts.

``export_packed_solver`` / ``export_fleet_tick`` /
``export_fleet_ticks_on_device`` trace the port's solver and fleet
programs with ``torch.export`` into versioned artifact files;
``load_artifact`` / ``load_packed_solver`` run them in a serving process
that imports none of the code that built them. Counterpart of
``kompass_core_tpu/serving``; see ``serving/export.py`` for the container
format and the device rule.
"""

from .export import (
    LoadedArtifact,
    export_callable,
    export_fleet_tick,
    export_fleet_ticks_on_device,
    export_packed_solver,
    load_artifact,
    load_packed_solver,
    read_artifact_header,
    shard_fleet_args,
    sharded_fleet_call,
)

__all__ = [
    "LoadedArtifact",
    "export_callable",
    "export_fleet_tick",
    "export_fleet_ticks_on_device",
    "export_packed_solver",
    "load_artifact",
    "load_packed_solver",
    "read_artifact_header",
    "shard_fleet_args",
    "sharded_fleet_call",
]
