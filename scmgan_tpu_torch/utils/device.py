"""Device selection for the port's entry points: the card unless the caller
asks for the CPU, and never a silent fall-back from one to the other; and
``no_tf32``, which keeps f32 convs in full f32 where a result sums them."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


@contextlib.contextmanager
def no_tf32():
    """Full f32 in cuDNN convs and matmuls inside the block (PyTorch lets
    cuDNN round f32 convs through TF32 by default), the caller's setting
    restored after it."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
