"""Multi-device paths over ``torch.distributed``: process-group setup and
meshes, the batch-split solve and train step, and the row-split megapixel
solver. Every name of torch_admm_deconv_tpu/parallel/__init__.py, plus
``init_distributed``, ``process_batch_bounds`` and the scatter and gather
helpers."""

from torch_admm_deconv_tpu_torch.parallel.data_parallel import (  # noqa: F401
    data_parallel_solve,
    make_dp_train_step,
    shard_batch,
)
from torch_admm_deconv_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    gather,
    init_distributed,
    local_block,
    make_mesh,
    process_batch_bounds,
    replicated,
    shard_host_batch,
    spatial_sharding,
)
from torch_admm_deconv_tpu_torch.parallel.spatial import (  # noqa: F401
    gather_rows,
    irfft2_sharded,
    rfft2_sharded,
    shard_rows,
    spatial_admm_tv,
    spatial_admm_tv_adaptive,
)
