"""Depthwise gaussian smoothing.

Port of ``scmgan_tpu/ops/smoothing.py`` (reference GaussianSmoothing,
models.py:315-378): a separable depthwise conv, two 1-D passes, equal to the
reference's k x k kernel (the outer product of the two 1-D gaussians).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_kernel1d(kernel_size: int, sigma: float, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """The reference's normalized 1-D gaussian, with its (x - mean) / (2 sigma)
    exponent (models.py:343-349)."""
    x = torch.arange(kernel_size, dtype=dtype, device=device)
    mean = (kernel_size - 1) / 2.0
    k = torch.exp(-(((x - mean) / (2.0 * sigma)) ** 2)) / (sigma * math.sqrt(2 * math.pi))
    return k / k.sum()


def gaussian_smooth2d(x: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Per-channel gaussian blur of an NHWC tensor, zero-padded to its size."""
    c = x.shape[-1]
    k = gaussian_kernel1d(kernel_size, sigma, x.dtype, x.device)
    pad = kernel_size // 2
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, k.reshape(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1),
                 padding=(pad, 0), groups=c)
    y = F.conv2d(y, k.reshape(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size),
                 padding=(0, pad), groups=c)
    return y.permute(0, 2, 3, 1)
