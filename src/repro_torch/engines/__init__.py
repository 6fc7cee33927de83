"""The port's engines: the shared runtime and pipeline state, the
device-resident superstep engine (``hype_superstep``) and the device loop
(``hype_device``)."""
from .device import DeviceParams, hype_device_partition

__all__ = ["DeviceParams", "hype_device_partition"]
