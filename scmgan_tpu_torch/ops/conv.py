"""Functional conv and linear layers on NHWC tensors with HWIO kernels.

Port of ``scmgan_tpu/ops/conv.py``.  The JAX package keeps NHWC so that the
channel axis rides the TPU's lanes; the port keeps the same layout at its
public functions so that every test compares like with like, and permutes to
PyTorch's NCHW / OIHW only around ``F.conv2d``.

Circular padding: the reference Transition declares ``padding=2,
padding_mode='circular'``, which torch expands to an effective 1-pixel wrap
on each side, i.e. a same-size 3x3 circular conv: wrap-pad 1, then VALID.

The ``*_init`` functions draw torch's default U(-b, b) from an explicit
``torch.Generator`` on the device the parameters are made on.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def _uniform(generator: torch.Generator, shape, bound: float,
             dtype) -> torch.Tensor:
    out = torch.empty(shape, dtype=dtype, device=generator.device)
    return out.uniform_(-bound, bound, generator=generator)


def _weight_and_bias(generator, kshape, out_ch, bound, dtype) -> dict:
    return {"w": _uniform(generator, kshape, bound, dtype),
            "b": _uniform(generator, (out_ch,), bound, dtype)}


def conv2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                ksize: int = 3, dtype=torch.float32) -> dict:
    """Torch-default (kaiming-uniform a=sqrt(5)) init: U(-b, b) with
    b = 1/sqrt(fan_in), fan_in = kh * kw * in_ch (conv.py:34)."""
    bound = 1.0 / math.sqrt(ksize * ksize * in_ch)
    return _weight_and_bias(generator, (ksize, ksize, in_ch, out_ch), out_ch,
                            bound, dtype)


def conv_transpose2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                          ksize: int = 3, dtype=torch.float32) -> dict:
    """Init of a stride-1 transposed conv stored as a plain HWIO kernel:
    torch's ConvTranspose2d bound 1/sqrt(kh * kw * out_ch) (conv.py:86)."""
    bound = 1.0 / math.sqrt(ksize * ksize * out_ch)
    return _weight_and_bias(generator, (ksize, ksize, in_ch, out_ch), out_ch,
                            bound, dtype)


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int,
                dtype=torch.float32) -> dict:
    """U(-b, b) with b = 1/sqrt(in_dim); weight (in, out) (conv.py:116)."""
    return _weight_and_bias(generator, (in_dim, out_dim), out_dim,
                            1.0 / math.sqrt(in_dim), dtype)


def circular_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Wrap-pad H and W of an NHWC tensor (toroidal topology)."""
    if pad == 0:
        return x
    x = torch.cat([x[:, -pad:], x, x[:, :pad]], dim=1)
    return torch.cat([x[:, :, -pad:], x, x[:, :, :pad]], dim=2)


def _same_pads(size: int, k: int, stride: int):
    """XLA's SAME padding (low, high) for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(
    params: dict,
    x: torch.Tensor,
    *,
    stride: int = 1,
    padding: str = "SAME",
    circular: bool = False,
    w: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """NHWC conv; ``w`` overrides ``params['w']`` (spectral norm injects the
    sigma-normalized weight through it)."""
    kernel = params["w"] if w is None else w
    kh, kw = kernel.shape[0], kernel.shape[1]
    if circular:
        x = circular_pad(x, (kh - 1) // 2)
        padding = "VALID"
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = _same_pads(x.shape[1], kh, stride)
        left, right = _same_pads(x.shape[2], kw, stride)
        xc = F.pad(xc, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"padding must be 'SAME' or 'VALID', not {padding!r}")
    y = F.conv2d(xc, kernel.permute(3, 2, 0, 1).to(x.dtype), stride=stride)
    return y.permute(0, 2, 3, 1) + params["b"].to(y.dtype)


def conv_transpose2d(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Stride-1, padding-1 transposed conv == SAME conv with the kernel
    flipped in H and W (``scmgan_tpu/ops/conv.py:102``)."""
    return conv2d(params, x, w=params["w"].flip(0, 1))


def linear(params: dict, x: torch.Tensor,
           w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ W + b in x's dtype (conv.py:124)."""
    kernel = params["w"] if w is None else w
    return x @ kernel.to(x.dtype) + params["b"].to(x.dtype)


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """Torch-default leaky ReLU slope (reference models.py:77)."""
    return F.leaky_relu(x, negative_slope)
