"""Several ranks (counterpart of ``blind_image_denoising_tpu/parallel``):
a mesh over the ranks of a ``torch.distributed`` process group,
data-parallel training, and spatial (halo-exchange) sharding for
full-frame inference. ``multihost`` joins the process group."""

from .mesh import (
    create_mesh,
    data_sharding,
    replicate_sharding,
    shard_batch,
    shard_train_step,
)
from .spatial import (
    spatial_sharding,
    spatial_shard_image,
    denoise_spatially_sharded,
)
