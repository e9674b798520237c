"""The box-world family, batched over B on the device: boxes, multibox,
rotating_boxes.

Port of ``scmgan_tpu/envs/boxes.py`` (reference envs/boxes.py,
envs/multibox.py, envs/rotating_boxes.py).  Single-channel 64x64 frames,
4 actions (0/1 move x by -3/+3, 2/3 move y), zero reward, no terminal
state, and a step draws nothing.  boxes: one box with toroidal wraparound
and a per-sample random size.  multibox: a controllable box and a static
one.  rotating_boxes: a square that spins by 3 a step while the agent
translates it; its integer "degrees" go into radian arithmetic, the
reference's quirk (envs/rotating_boxes.py:55-58).

The arithmetic is f32, as the JAX package's: boxes' width is an f32
uniform, and ``x - width`` is truncated toward zero before the clip.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scmgan_tpu_torch.envs.base import (EnvSpec, draw_ints, draw_nothing, draw_uniform,
                                        no_reward, register)
from scmgan_tpu_torch.envs.raster import slice_rect_mask

G = 64


def _move_xy(x, y, action):
    """The boxes action map (reference envs/boxes.py:24-32): 0/1 move x,
    2/3 move y, by 3."""
    action = action.long()
    dx = torch.where(action == 0, -3, torch.where(action == 1, 3, 0))
    dy = torch.where(action == 2, -3, torch.where(action == 3, 3, 0))
    return x + dx, y + dy


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------

class BoxState(NamedTuple):
    width: torch.Tensor   # (B,) float32
    height: torch.Tensor  # (B,) int64
    x: torch.Tensor
    y: torch.Tensor


def boxes_reset(batch_size: int, device=None, generator: torch.Generator = None) -> BoxState:
    """A random size and position, drawn from ``generator`` on its device."""
    return BoxState(width=draw_uniform(generator, (batch_size,), 5.0, 10.0),
                    height=draw_ints(generator, batch_size, 5, 10),
                    x=draw_ints(generator, batch_size, 4, G - 4),
                    y=draw_ints(generator, batch_size, 4, G - 4))


def boxes_step(state: BoxState, action: torch.Tensor, noise=None):
    x, y = _move_xy(state.x, state.y, action)
    return (BoxState(state.width, state.height, x % G, y % G), *no_reward(x))


def _boxes_frame(width, height, x, y) -> torch.Tensor:
    """build_state (reference envs/boxes.py:57-68): the bounds truncated
    toward zero (``x - width`` is f32 where the width is), clipped to
    [0, 63], filled on the half-open ranges."""
    def edge(v):
        return torch.clamp(v.to(torch.int64), 0, G - 1)

    return slice_rect_mask(G, G, edge(y - height), edge(y + height),
                           edge(x - width), edge(x + width))[..., None]


def boxes_render(s: BoxState) -> torch.Tensor:
    return _boxes_frame(s.width, s.height, s.x, s.y)


def _boxes_simulator(factor_batch) -> np.ndarray:
    """Factors (B, 4) in [0, 1] -> frames (B, H, W, 1)
    (generate_image_continuous, reference envs/boxes.py:50-55), in f32 as
    the JAX package computes them.  Runs on the CPU."""
    z = torch.as_tensor(np.asarray(factor_batch, np.float32))
    i = lambda v: v.to(torch.int64)  # noqa: E731
    return _boxes_frame(i(z[:, 0] * 5) + 5, i(z[:, 1] * 5) + 5,
                        i(z[:, 2] * G), i(z[:, 3] * G)).numpy()


@register("boxes")
def make_boxes() -> EnvSpec:
    return EnvSpec(
        name="boxes", num_actions=4, num_rewards=1, channels=1, height=G, width=G,
        reset=boxes_reset, draw_noise=draw_nothing, step=boxes_step,
        render=boxes_render, true_latent_dim=4, simulator=_boxes_simulator)


# ---------------------------------------------------------------------------
# multibox
# ---------------------------------------------------------------------------

class MultiboxState(NamedTuple):
    red_x: torch.Tensor   # (B,) int64
    red_y: torch.Tensor
    red_r: torch.Tensor
    blue_x: torch.Tensor
    blue_y: torch.Tensor
    blue_r: torch.Tensor


def multibox_reset(batch_size: int, device=None,
                   generator: torch.Generator = None) -> MultiboxState:
    d = lambda lo, hi: draw_ints(generator, batch_size, lo, hi)  # noqa: E731
    return MultiboxState(red_x=d(10, 50), red_y=d(10, 50), red_r=d(5, 8),
                         blue_x=d(10, 50), blue_y=d(10, 50), blue_r=d(2, 4))


def multibox_step(state: MultiboxState, action: torch.Tensor, noise=None):
    x, y = _move_xy(state.red_x, state.red_y, action)
    return (state._replace(red_x=x, red_y=y), *no_reward(x))


def multibox_render(s: MultiboxState) -> torch.Tensor:
    red = slice_rect_mask(G, G, s.red_y - s.red_r, s.red_y + s.red_r,
                          s.red_x - s.red_r, s.red_x + s.red_r)
    blue = slice_rect_mask(G, G, s.blue_y - s.blue_r, s.blue_y + s.blue_r,
                           s.blue_x - s.blue_r, s.blue_x + s.blue_r)
    return torch.maximum(red, blue)[..., None]


@register("multibox")
def make_multibox() -> EnvSpec:
    return EnvSpec(
        name="multibox", num_actions=4, num_rewards=1, channels=1, height=G, width=G,
        reset=multibox_reset, draw_noise=draw_nothing, step=multibox_step,
        render=multibox_render)


# ---------------------------------------------------------------------------
# rotating_boxes
# ---------------------------------------------------------------------------

class RotBoxState(NamedTuple):
    width: torch.Tensor     # (B,) float32
    x: torch.Tensor         # (B,) int64
    y: torch.Tensor
    rotation: torch.Tensor  # int "degrees" read as radians (the reference's quirk)


def rotbox_reset(batch_size: int, device=None,
                 generator: torch.Generator = None) -> RotBoxState:
    return RotBoxState(width=draw_uniform(generator, (batch_size,), 5.0, 10.0),
                       x=draw_ints(generator, batch_size, 20, 46),
                       y=draw_ints(generator, batch_size, 20, 46),
                       rotation=draw_ints(generator, batch_size, 0, 90))


def rotbox_step(state: RotBoxState, action: torch.Tensor, noise=None):
    x, y = _move_xy(state.x, state.y, action)
    return (RotBoxState(state.width, x, y, state.rotation + 3), *no_reward(x))


_CORNERS = np.array([np.pi / 4, 3 * np.pi / 4, 5 * np.pi / 4, 7 * np.pi / 4], np.float32)


def rotbox_crosses(width, x, y, rotation) -> torch.Tensor:
    """(B, 4, H, W) f32: for each edge of the square, the cross product of
    the edge with each pixel's offset from its first corner.  Corners at
    polar angles rotation + (2k+1) pi/4, radius ``width``.  A pixel is
    inside where all four are >= 0; one within an ulp or so of 0 lies on
    an edge, where the last bit of sin/cos decides."""
    dev = x.device
    angles = rotation.to(torch.float32)[:, None] + torch.from_numpy(_CORNERS).to(dev)
    width = torch.as_tensor(width, dtype=torch.float32, device=dev)[:, None]
    cy = y.to(torch.float32)[:, None] + width * torch.sin(angles)   # (B, 4)
    cx = x.to(torch.float32)[:, None] + width * torch.cos(angles)
    rows = torch.arange(G, device=dev, dtype=torch.float32)[None, :, None]
    cols = torch.arange(G, device=dev, dtype=torch.float32)[None, None, :]
    crosses = []
    for k in range(4):
        ax, ay = cx[:, k, None, None], cy[:, k, None, None]
        bx, by = cx[:, (k + 1) % 4, None, None], cy[:, (k + 1) % 4, None, None]
        crosses.append((bx - ax) * (rows - ay) - (by - ay) * (cols - ax))
    return torch.stack(crosses, dim=1)


def _rotbox_frame(width, x, y, rotation) -> torch.Tensor:
    """The filled rotated square by half-plane intersection (the reference
    fills the same quad with skimage.draw.polygon,
    envs/rotating_boxes.py:52-61)."""
    inside = (rotbox_crosses(width, x, y, rotation) >= 0).all(dim=1)
    return inside.to(torch.float32)[..., None]


def rotbox_render(s: RotBoxState) -> torch.Tensor:
    return _rotbox_frame(s.width, s.x, s.y, s.rotation)


def _rotbox_factors(z: torch.Tensor):
    """generate_image_continuous (reference envs/rotating_boxes.py:43-49):
    (width, x, y, rotation) from the factors; the second factor is unused."""
    i = lambda v: v.to(torch.int64)  # noqa: E731
    return (i(z[:, 0] * 15).to(torch.float32) + 5, i(z[:, 2] * 26) + 20,
            i(z[:, 3] * 26) + 20, i(z[:, 4] * 90))


def _rotbox_simulator(factor_batch) -> np.ndarray:
    """Factors (B, 5) in [0, 1] -> frames (B, H, W, 1).  Runs on the CPU."""
    z = torch.as_tensor(np.asarray(factor_batch, np.float32))
    return _rotbox_frame(*_rotbox_factors(z)).numpy()


@register("rotating_boxes")
def make_rotating_boxes() -> EnvSpec:
    return EnvSpec(
        name="rotating_boxes", num_actions=4, num_rewards=1, channels=1, height=G,
        width=G, reset=rotbox_reset, draw_noise=draw_nothing, step=rotbox_step,
        render=rotbox_render, true_latent_dim=5, simulator=_rotbox_simulator)
