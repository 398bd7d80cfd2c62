from .fleet_v2 import DeviceFleet  # noqa: F401
