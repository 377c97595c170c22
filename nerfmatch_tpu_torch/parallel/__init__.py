"""Device meshes, placement and the multi-process group (counterpart of
``nerfmatch_tpu/parallel``)."""

from .mesh import (
    make_mesh,
    data_sharding,
    replicated,
    shard_batch,
    replicate_params,
    all_gather_host,
)
