"""Data, tensor, spatial and pipeline parallelism (port of
``scmgan_tpu/parallel``): one process per device under
``torch.distributed``; see ``mesh.py``, ``distributed.py`` and
``pipeline.py``."""

from scmgan_tpu_torch.parallel.mesh import (  # noqa: F401
    spatial_activation_sharding,
    make_mesh,
    leaf_spec,
    param_shardings,
    batch_shardings,
    shard_pytree,
    shard_train_step,
)
