"""CSRN: the convolutional spatial recurrent network.

Port of ``scmgan_tpu/ops/csrn.py`` (reference spatial_recurrent.py:21-139;
a library component, unused by the model classes).  Four bias-free GRUs
sweep the image top-down, bottom-up, left-right and right-left; between
consecutive rows (columns) the recurrent state passes through a 1-D conv
and tanh, so that activations spread like a cone; the four context maps
combine through a 1x1 conv.  ``exploding_init`` draws the reference's
normal(0, channels) weights.  As in the JAX package, the right sweep keeps
its own context map (the reference's writes over the left one,
spatial_recurrent.py:116).

Each sweep is a loop over rows (columns) with the (batch * width) GRU batch
in one matmul a step, where the JAX package scans.  Parameters use the JAX
package's tree and layouts: GRU weights (in, 3 * hidden) in torch's gate
order (r, z, n), conv1d kernels (k, in, out), the combine conv HWIO.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from scmgan_tpu_torch.ops.conv import conv2d

DIRECTIONS = ("down", "up", "left", "right")


def _normal(generator: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return scale * torch.randn(shape, generator=generator, device=generator.device,
                               dtype=dtype)


def gru_init(generator: torch.Generator, in_dim: int, hidden: int, scale: float,
             dtype=torch.float32) -> dict:
    """Bias-free GRU weights, the r / z / n gates stacked on the last axis."""
    return {"w_ih": _normal(generator, (in_dim, 3 * hidden), scale, dtype),
            "w_hh": _normal(generator, (hidden, 3 * hidden), scale, dtype)}


def gru_cell(params: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One bias-free GRU step (torch's gate order r, z, n)."""
    i_r, i_z, i_n = (x @ params["w_ih"]).chunk(3, dim=-1)
    h_r, h_z, h_n = (h @ params["w_hh"]).chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def conv1d_init(generator: torch.Generator, in_ch: int, out_ch: int, scale: float,
                ksize: int = 3, dtype=torch.float32) -> dict:
    return {"w": _normal(generator, (ksize, in_ch, out_ch), scale, dtype),
            "b": torch.zeros((out_ch,), dtype=dtype, device=generator.device)}


def conv1d(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, L, C) -> (B, L, C_out), SAME padding (odd kernel)."""
    w = params["w"]
    y = F.conv1d(x.permute(0, 2, 1), w.permute(2, 1, 0), padding=(w.shape[0] - 1) // 2)
    return y.permute(0, 2, 1) + params["b"]


def csrn_init(generator: torch.Generator, channels: int, exploding_init: bool = True,
              dtype=torch.float32) -> dict:
    """The four sweeps' conv1d and GRU weights and the 1x1 combine conv,
    drawn in the JAX package's order from ``generator`` on its device."""
    scale = float(channels) if exploding_init else 1.0 / math.sqrt(channels)
    p = {}
    for d in DIRECTIONS:
        p[f"conv_{d}"] = conv1d_init(generator, channels, channels, scale, dtype=dtype)
    for d in DIRECTIONS:
        p[f"rnn_{d}"] = gru_init(generator, channels, channels, scale, dtype)
    p["conv_combine"] = {
        "w": _normal(generator, (1, 1, channels * 4, channels), 1.0 / (channels * 2.0), dtype),
        "b": torch.zeros((channels,), dtype=dtype, device=generator.device)}
    return p


def _sweep(lines: torch.Tensor, rnn: dict, conv: dict, reverse: bool) -> torch.Tensor:
    """lines: (L, B, W, C), a sequence of rows (or columns), swept first to
    last (last to first with ``reverse``).  Returns each line's GRU output
    (L, B, W, C) at the line's own index."""
    n, b, w, c = lines.shape
    h = lines.new_zeros((b * w, c))
    out = [None] * n
    for i in (reversed(range(n)) if reverse else range(n)):
        ctx = gru_cell(rnn, lines[i].reshape(b * w, c), h).reshape(b, w, c)
        out[i] = ctx
        h = torch.tanh(conv1d(conv, ctx)).reshape(b * w, c)
    return torch.stack(out)


def csrn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) NHWC -> (B, H, W, C)."""
    rows = x.permute(1, 0, 2, 3)                    # (H, B, W, C)
    cols = x.permute(2, 0, 1, 3)                    # (W, B, H, C)
    above = _sweep(rows, params["rnn_down"], params["conv_down"], False)
    below = _sweep(rows, params["rnn_up"], params["conv_up"], True)
    left = _sweep(cols, params["rnn_left"], params["conv_left"], False)
    right = _sweep(cols, params["rnn_right"], params["conv_right"], True)
    ctx = torch.cat([above.permute(1, 0, 2, 3), below.permute(1, 0, 2, 3),
                     left.permute(1, 2, 0, 3), right.permute(1, 2, 0, 3)], dim=-1)
    return conv2d(params["conv_combine"], ctx)
