"""The port's engines: the shared runtime and pipeline state, the
device-resident superstep engine (``hype_superstep``), the device loop
(``hype_device``) and the phase-group-sharded engine (``hype_sharded``)
with the spawned ranks that give one caller a mesh."""
from .device import DeviceParams, hype_device_partition
from .sharded import (RankPool, ShardedParams, ShardedState,
                      hype_sharded_partition, spawn_partition)

__all__ = ["DeviceParams", "RankPool", "ShardedParams", "ShardedState",
           "hype_device_partition", "hype_sharded_partition",
           "spawn_partition"]
