"""Runtime helpers of the PyTorch port: ``compat`` (meshes, local ranks,
feature detection) and ``fault_tolerance`` (the resilient train loop)."""
from repro_torch.runtime.compat import (
    AXIS_TYPE_AUTO,
    HAS_AXIS_TYPE,
    make_mesh_compat,
    mesh_axis_types_kwargs,
)
from repro_torch.runtime.fault_tolerance import (
    ResilientLoop,
    StragglerMonitor,
    elastic_reshard,
)

__all__ = [
    "ResilientLoop",
    "StragglerMonitor",
    "elastic_reshard",
    "AXIS_TYPE_AUTO",
    "HAS_AXIS_TYPE",
    "make_mesh_compat",
    "mesh_axis_types_kwargs",
]
