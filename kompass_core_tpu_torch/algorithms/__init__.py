from .dvz import DeformableVirtualZone, DeformableVirtualZoneParams  # noqa: F401
