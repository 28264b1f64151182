"""Data parallelism on ``torch.distributed``, and the one-process device mesh of
serving. Port of ``eovax/parallel``."""

from eovax_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    REPLICATED_BATCH_KEYS,
    DataMesh,
    DeviceMesh,
    init_distributed,
    local_numpy,
    make_device_mesh,
    make_mesh,
    place_batch,
)
