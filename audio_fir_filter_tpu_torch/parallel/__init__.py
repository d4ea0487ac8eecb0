from .mesh import (DATA_AXIS, TIME_AXIS, Cell, Mesh, local_devices, make_mesh,
                   single_device_mesh)
from .sharded_conv import (LocalShards, assemble, pad_for_mesh, sharded_filter,
                           sharded_filter_padded)

__all__ = [
    "DATA_AXIS",
    "TIME_AXIS",
    "Cell",
    "Mesh",
    "LocalShards",
    "local_devices",
    "make_mesh",
    "single_device_mesh",
    "assemble",
    "pad_for_mesh",
    "sharded_filter",
    "sharded_filter_padded",
]
