"""Process groups and each process's slice of the batch.

Port of ``scmgan_tpu/parallel/distributed.py``.  The JAX package runs one
process per host over all of its chips and ``jax.distributed`` joins the
hosts; PyTorch runs one process per device, launched by ``torchrun``
(which sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``), and ``torch.distributed`` joins them: NCCL between cards,
gloo between CPU processes.  That launcher is the one difference by design;
what a process sees is the same: a single process is a no-op, and each
process feeds its slice of the global batch.

    torchrun --nproc-per-node 2 -m scmgan_tpu_torch --platform cpu --mesh 2x1 ...

A launcher without a TCP rendezvous (the tests' spawned processes) passes
``init_method`` (``file://...``), or sets ``SCMGAN_INIT_METHOD`` for the
command line.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group when more than one process runs.

    Resolution order: the arguments, then the launcher's variables
    (``SCMGAN_INIT_METHOD``, else ``env://`` with torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``; ``WORLD_SIZE``; ``RANK``).  Returns
    False, and makes no group, when neither names more than one process
    (distributed.py:22).  The backend is NCCL for a CUDA process and gloo
    on the CPU (by default: NCCL where a card is available); under NCCL the
    process first binds ``LOCAL_RANK``'s card.
    """
    world_size = world_size or int(os.environ.get("WORLD_SIZE", "0")) or None
    if world_size is None or world_size <= 1:
        return False
    rank = rank if rank is not None else int(os.environ.get("RANK", "-1"))
    if rank < 0:
        raise ValueError(f"WORLD_SIZE is {world_size} but no RANK is given")
    init_method = (init_method or os.environ.get("SCMGAN_INIT_METHOD")
                   or "env://")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def shutdown():
    """Destroy the process group."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_batch_slice(global_batch: int, mesh=None,
                        data_axis: str = "data") -> Tuple[int, int]:
    """(local_batch, offset) of this process's rows of a global batch
    (distributed.py:51).

    Under ``mesh`` (a ``DeviceMesh``) the rows divide over its
    ``data_axis``: the processes of one 'model' group hold the same rows,
    so the world size would be the wrong divisor.  Without a mesh they
    divide over the process group, or stay whole in a lone process.
    """
    if mesh is not None:
        n = mesh.size(mesh.mesh_dim_names.index(data_axis))
        index = mesh.get_local_rank(data_axis)
    elif dist.is_initialized():
        n, index = dist.get_world_size(), dist.get_rank()
    else:
        n, index = 1, 0
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} must divide over {n} processes")
    local = global_batch // n
    return local, index * local


def local_device_count() -> int:
    """This host's devices: its cards, or the CPU as one device."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1
