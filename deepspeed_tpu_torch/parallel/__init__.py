from .topology import (
    MeshSpec,
    PipeDataParallelTopology,
    PipeModelDataParallelTopology,
    ProcessGroups,
    ProcessTopology,
    single_device_mesh,
)
