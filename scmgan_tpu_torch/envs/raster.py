"""Branchless rasterization helpers of the synthetic environments, batched.

Port of ``scmgan_tpu/envs/raster.py``: rectangles are comparisons of row and
column indices against per-sample bounds, so a batch of B environments draws
in one pass with no data-dependent shapes.  Every coordinate is a (B,)
integer tensor (or a Python int, broadcast to the batch).

Pixel-exact parity with the reference's draw_rect: left = max(cx-w, 0),
right = min(cx+w, W-1), rows/cols painted on the half-open ranges
[top, bottom) x [left, right).
"""

from __future__ import annotations

import torch


def _batch(*coords):
    """The coordinates as (B, 1, 1) int64 tensors on the first tensor's
    device, Python ints broadcast to the batch."""
    ref = next(c for c in coords if torch.is_tensor(c))
    out = torch.broadcast_tensors(*(
        torch.as_tensor(c, dtype=torch.int64, device=ref.device) for c in coords))
    return tuple(c[:, None, None] for c in out)


def rect_mask(height: int, width: int, cx, cy, half_w, half_h) -> torch.Tensor:
    """(B, H, W) float32 mask of the reference's draw_rect rectangle."""
    cx, cy, half_w, half_h = _batch(cx, cy, half_w, half_h)
    left = torch.clamp(cx - half_w, min=0)
    right = torch.clamp(cx + half_w, max=width - 1)
    top = torch.clamp(cy - half_h, min=0)
    bottom = torch.clamp(cy + half_h, max=height - 1)
    rows = torch.arange(height, device=cx.device)[None, :, None]
    cols = torch.arange(width, device=cx.device)[None, None, :]
    return ((rows >= top) & (rows < bottom) & (cols >= left) & (cols < right)
            ).to(torch.float32)


def paint(frame: torch.Tensor, channel: int, mask: torch.Tensor) -> torch.Tensor:
    """``frame`` (B, H, W, C) with ``frame[..., channel]`` set to 1 where the
    (B, H, W) mask is set."""
    out = frame.clone()
    out[..., channel] = torch.maximum(out[..., channel], mask)
    return out


def np_slice_mask(n: int, start, stop) -> torch.Tensor:
    """(B, n) bool mask replicating numpy slice semantics ``arr[start:stop]``
    per sample, including negative-index wraparound (a negative start one
    past the left edge yields an *empty* slice in numpy, e.g. ``arr[-1:1]``;
    several reference envs rely on this to make ball tails vanish at edges)."""
    start, stop = (c[:, 0, 0] for c in _batch(start, stop))
    start = torch.clamp(torch.where(start < 0, start + n, start), 0, n)
    stop = torch.clamp(torch.where(stop < 0, stop + n, stop), 0, n)
    idx = torch.arange(n, device=start.device)[None, :]
    return (idx >= start[:, None]) & (idx < stop[:, None])


def slice_rect_mask(height: int, width: int, y0, y1, x0, x1) -> torch.Tensor:
    """(B, H, W) float32 mask of ``pixels[y0:y1, x0:x1] = 1`` with exact
    numpy slice semantics on both axes."""
    rows = np_slice_mask(height, y0, y1)
    cols = np_slice_mask(width, x0, x1)
    return (rows[:, :, None] & cols[:, None, :]).to(torch.float32)
