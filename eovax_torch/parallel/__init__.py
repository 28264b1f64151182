"""Data parallelism on ``torch.distributed``. Port of ``eovax/parallel``."""

from eovax_torch.parallel.mesh import (  # noqa: F401
    REPLICATED_BATCH_KEYS,
    DataMesh,
    init_distributed,
    local_numpy,
    make_mesh,
    place_batch,
)
