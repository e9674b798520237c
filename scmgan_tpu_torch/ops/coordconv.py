"""CoordConv: a conv with x / y coordinate channels appended.

Port of ``scmgan_tpu/ops/coordconv.py`` (reference coordconv.py:5-15; a
library component, unused by the model classes), NHWC.
"""

from __future__ import annotations

import torch

from scmgan_tpu_torch.ops.conv import conv2d, conv2d_init


def coord_channels(batch: int, height: int, width: int, dtype=torch.float32,
                   device=None):
    """The [-1, 1) coordinate planes (B, H, W, 1) each, as
    ``torch.arange(-1, 1, 2 / n)`` gives them."""
    xs = torch.arange(-1.0, 1.0, 2.0 / width, dtype=dtype, device=device)[:width]
    ys = torch.arange(-1.0, 1.0, 2.0 / height, dtype=dtype, device=device)[:height]
    cx = xs[None, None, :, None].expand(batch, height, width, 1)
    cy = ys[None, :, None, None].expand(batch, height, width, 1)
    return cx, cy


def coordconv2d_init(generator: torch.Generator, in_ch: int, out_ch: int, ksize: int = 3,
                     dtype=torch.float32) -> dict:
    return conv2d_init(generator, in_ch + 2, out_ch, ksize, dtype)


def coordconv2d(params: dict, x: torch.Tensor, **kw) -> torch.Tensor:
    b, h, w, _ = x.shape
    cx, cy = coord_channels(b, h, w, x.dtype, x.device)
    return conv2d(params, torch.cat([x, cx, cy], dim=-1), **kw)
