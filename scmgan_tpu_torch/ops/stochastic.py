"""Discretization of the transition's sigmoid output.

Port of ``scmgan_tpu/ops/stochastic.py``.  JAX draws its Bernoulli bits from
a key inside ``st_bernoulli``; PyTorch's generators give other bits, so the
port takes the uniform draw as a tensor and the tests hand both sides the
same numbers.  ``random_eps`` and ``hypersphere_norm`` are the reference's
unused library leftovers, kept for parity as the JAX module keeps them.
"""

from __future__ import annotations

from typing import Optional

import torch


def st_bernoulli(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Straight-through Bernoulli sample: the value is ``u < p`` (a draw from
    Bernoulli(p) for u uniform on [0, 1)), the gradient is the identity."""
    sample = (u < p).to(p.dtype)
    return p + (sample - p).detach()


def hard_threshold(p: torch.Tensor, thresh: float = 0.5) -> torch.Tensor:
    """Eval-mode discretization: (p > 0.5) as float (reference models.py:112)."""
    return (p > thresh).to(p.dtype)


def random_eps(generator: Optional[torch.Generator] = None, p: float = 0.5,
               batch_size: int = 32, height: int = 64, width: int = 64,
               channels: int = 3, u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A Bernoulli(p) noise map (B, H, W, C) f32 (reference models.py:24-26;
    unused by the main path): ``u < p`` for uniforms ``u`` of that shape,
    injected or drawn from ``generator`` on its device."""
    if u is None:
        if generator is None:
            raise ValueError("pass a generator or the uniforms u")
        u = torch.rand((batch_size, height, width, channels), generator=generator,
                       device=generator.device)
    return (u < p).to(torch.float32)


def hypersphere_norm(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Each sample of a batch scaled to unit L2 norm (reference
    models.py:382-385 ``norm``; unused by the main path)."""
    n = torch.linalg.vector_norm(x.reshape(x.shape[0], -1), dim=1)
    return x / (n.reshape((-1,) + (1,) * (x.ndim - 1)) + eps)
