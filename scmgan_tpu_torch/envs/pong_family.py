"""The pong family, batched over B on the device: minipong, mediumpong,
staticpong, superpong, hardpong, realpong.

Port of ``scmgan_tpu/envs/pong_family.py`` (reference envs/minipong.py,
mediumpong.py, staticpong.py, superpong.py, hardpong.py, realpong.py), with
the same integer dynamics and the rendering quirks the models were trained
against: minipong wraps its positions mod 64 but clips them in the render;
mediumpong draws its ball's tail as if the velocity were -1; staticpong
renders one constant pattern whatever the state; realpong ends its episode
on a score.  All share 64x64x3 frames and 4 actions (0/1 move the right
paddle by -3/+3, 2/3 the left one); a step draws nothing.

The Higgins simulators cast their factors to f32 before ``int(z * 64)``, as
the JAX package does: numpy hands over f64, and f64 arithmetic moves a
pixel at every factor that lands on a boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scmgan_tpu_torch.envs.base import EnvSpec, draw_ints, draw_nothing, no_reward, register
from scmgan_tpu_torch.envs.raster import rect_mask, slice_rect_mask

G = 64
CHANNELS = 3


def _paddle_dy(action):
    """Actions 0/1 -> right paddle -3/+3, 2/3 -> left paddle -3/+3."""
    action = action.long()
    d_right = torch.where(action == 0, -3, torch.where(action == 1, 3, 0))
    d_left = torch.where(action == 2, -3, torch.where(action == 3, 3, 0))
    return d_left, d_right


def _frame(like: torch.Tensor) -> torch.Tensor:
    """A black (B, H, W, C) frame on ``like``'s device."""
    return torch.zeros((like.shape[0], G, G, CHANNELS), dtype=torch.float32,
                       device=like.device)


def _paint(frame: torch.Tensor, channel: int, mask: torch.Tensor):
    """``frame[..., channel] = max(frame[..., channel], mask)`` in place."""
    frame[..., channel] = torch.maximum(frame[..., channel], mask)


def _simulator(render_from_factors):
    """A Higgins simulator: factors (B, 4) in [0, 1], cast to f32 -> frames
    (B, H, W, C) as numpy.  Runs on the CPU."""
    def simulator(factor_batch) -> np.ndarray:
        z = torch.as_tensor(np.asarray(factor_batch, np.float32))
        return render_from_factors(z).numpy()
    return simulator


def _positions(z: torch.Tensor):
    """The four positions ``int(z[:, i] * 64)``, truncated toward zero."""
    return tuple((z[:, i] * G).to(torch.int64) for i in range(4))


def _paddles(frame, left_y, right_y, ph=4, pw=1):
    """Blue left paddle, red right paddle, positions clipped into
    [ph, G - ph] (the superpong family's build_state)."""
    ly = torch.clamp(left_y, ph, G - ph)
    ry = torch.clamp(right_y, ph, G - ph)
    left_x, right_x = torch.full_like(ly, 4), torch.full_like(ly, G - 4)
    _paint(frame, 2, slice_rect_mask(G, G, ly - ph, ly + ph, left_x - pw, left_x + pw))
    _paint(frame, 0, slice_rect_mask(G, G, ry - ph, ry + ph, right_x - pw, right_x + pw))


# ===========================================================================
# minipong (reference envs/minipong.py): no velocity, positions wrap mod 64,
# white paddles and ball, ball_x += 3 mod 64, zero reward.
# ===========================================================================

class MinipongState(NamedTuple):
    left_y: torch.Tensor  # (B,) int64
    right_y: torch.Tensor
    ball_x: torch.Tensor
    ball_y: torch.Tensor


def _minipong_render(left_y, right_y, ball_x, ball_y) -> torch.Tensor:
    """build_state (reference envs/minipong.py:52-73): positions clipped
    into [4, G - 4], every channel painted white."""
    ph, pw, bs = 4, 1, 2
    ly, ry, bx, by = (torch.clamp(v, ph, G - ph) for v in (left_y, right_y, ball_x, ball_y))
    left_x, right_x = torch.full_like(ly, 4), torch.full_like(ly, G - 4)
    m = slice_rect_mask(G, G, ly - ph, ly + ph, left_x - pw, left_x + pw)
    m = torch.maximum(m, slice_rect_mask(G, G, ry - ph, ry + ph, right_x - pw, right_x + pw))
    m = torch.maximum(m, slice_rect_mask(G, G, by - bs, by + bs, bx - bs, bx + bs))
    return m[..., None].expand(-1, -1, -1, CHANNELS).contiguous()


def minipong_reset(batch_size: int, device=None,
                   generator: torch.Generator = None) -> MinipongState:
    return MinipongState(*(draw_ints(generator, batch_size, 0, G) for _ in range(4)))


def minipong_step(state: MinipongState, action: torch.Tensor, noise=None):
    d_left, d_right = _paddle_dy(action)
    return (MinipongState(left_y=(state.left_y + d_left) % G,
                          right_y=(state.right_y + d_right) % G,
                          ball_x=(state.ball_x + 3) % G, ball_y=state.ball_y),
            *no_reward(state.ball_x))


def minipong_render(s: MinipongState) -> torch.Tensor:
    return _minipong_render(s.left_y, s.right_y, s.ball_x, s.ball_y)


@register("minipong")
def make_minipong() -> EnvSpec:
    return EnvSpec(
        name="minipong", num_actions=4, num_rewards=1, channels=CHANNELS, height=G,
        width=G, reset=minipong_reset, draw_noise=draw_nothing, step=minipong_step,
        render=minipong_render, true_latent_dim=4,
        simulator=_simulator(lambda z: _minipong_render(*_positions(z))))


# ===========================================================================
# mediumpong (reference envs/mediumpong.py): an x-velocity ball bouncing at
# the walls; the render draws the tail as if the velocity were -1
# (envs/mediumpong.py:70).
# ===========================================================================

class MediumpongState(NamedTuple):
    left_y: torch.Tensor  # (B,) int64
    right_y: torch.Tensor
    ball_x: torch.Tensor
    ball_y: torch.Tensor
    vel: torch.Tensor


def _mediumpong_render(left_y, right_y, ball_x, ball_y) -> torch.Tensor:
    bs = 2
    frame = _frame(left_y)
    _paddles(frame, left_y, right_y)
    bx = torch.clamp(ball_x, bs, G - bs)
    by = torch.clamp(ball_y, bs, G - bs)
    # the velocity forced to -1: colour (0, 1, .5), tail to the right
    # (envs/mediumpong.py:70-95)
    body = slice_rect_mask(G, G, by - bs, by + bs, bx - bs, bx + bs)
    tail = slice_rect_mask(G, G, by - 1, by + 1, bx - bs, bx + bs + 3)
    ball = torch.maximum(body, tail)
    for idx, c in enumerate((0.0, 1.0, 0.5)):
        _paint(frame, idx, ball * c)
    return frame


def mediumpong_reset(batch_size: int, device=None,
                     generator: torch.Generator = None) -> MediumpongState:
    d = lambda lo, hi: draw_ints(generator, batch_size, lo, hi)  # noqa: E731
    return MediumpongState(left_y=d(0, G), right_y=d(0, G), ball_x=d(0, G),
                           ball_y=d(0, G), vel=4 * d(0, 2) - 2)


def mediumpong_step(state: MediumpongState, action: torch.Tensor, noise=None):
    d_left, d_right = _paddle_dy(action)
    ball_x = state.ball_x + state.vel
    vel = torch.where(((ball_x >= G - 5) & (state.vel > 0))
                      | ((ball_x <= 5) & (state.vel < 0)), -state.vel, state.vel)
    return (MediumpongState(left_y=state.left_y + d_left, right_y=state.right_y + d_right,
                            ball_x=ball_x, ball_y=state.ball_y, vel=vel),
            *no_reward(ball_x))


def mediumpong_render(s: MediumpongState) -> torch.Tensor:
    return _mediumpong_render(s.left_y, s.right_y, s.ball_x, s.ball_y)


@register("mediumpong")
def make_mediumpong() -> EnvSpec:
    return EnvSpec(
        name="mediumpong", num_actions=4, num_rewards=1, channels=CHANNELS, height=G,
        width=G, reset=mediumpong_reset, draw_noise=draw_nothing, step=mediumpong_step,
        render=mediumpong_render, true_latent_dim=4,
        simulator=_simulator(lambda z: _mediumpong_render(*_positions(z))))


# ===========================================================================
# staticpong (reference envs/staticpong.py): mediumpong's dynamics, but the
# renderer overrides every position with a constant on a 0.5 background
# (envs/staticpong.py:62-70), so the frame is one test pattern.
# ===========================================================================

def _staticpong_pattern() -> torch.Tensor:
    ph, pw, bs = 4, 3, 4
    left_x, right_x = 15, G - 15
    ly, ry, bx, by = 20, 30, 30, 40
    frame = torch.full((G, G, CHANNELS), 0.5, dtype=torch.float32)
    frame[ly - ph:ly + ph, left_x - pw:left_x + pw, 2] = 1.0
    frame[ry - ph:ry + ph, right_x - pw:right_x + pw, 0] = 1.0
    # velocity +1: colour (.5, 1, 0), tail to the left
    for idx, c in enumerate((0.5, 1.0, 0.0)):
        frame[by - bs:by + bs, bx - bs:bx + bs, idx] = c
        frame[by - 1:by + 1, bx - bs - 3:bx + bs, idx] = c
    return frame


def _staticpong_render(like: torch.Tensor) -> torch.Tensor:
    """The pattern, once for each sample of ``like`` (B, ...), on its device."""
    pattern = _staticpong_pattern().to(like.device)
    return pattern.expand(like.shape[0], -1, -1, -1).contiguous()


def staticpong_render(s: MediumpongState) -> torch.Tensor:
    return _staticpong_render(s.ball_x)


@register("staticpong")
def make_staticpong() -> EnvSpec:
    return EnvSpec(
        name="staticpong", num_actions=4, num_rewards=1, channels=CHANNELS, height=G,
        width=G, reset=mediumpong_reset, draw_noise=draw_nothing, step=mediumpong_step,
        render=staticpong_render, true_latent_dim=4,
        simulator=_simulator(_staticpong_render))


# ===========================================================================
# superpong (reference envs/superpong.py): x/y velocity with wall and
# paddle-conditional bounces; a green ball with a direction tail.
# ===========================================================================

class VelState(NamedTuple):
    left_y: torch.Tensor  # (B,) int64
    right_y: torch.Tensor
    ball_x: torch.Tensor
    ball_y: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor


def vel_reset(batch_size: int, device=None, generator: torch.Generator = None,
              margin: int = 4, x_margin: int = 5) -> VelState:
    d = lambda lo, hi: draw_ints(generator, batch_size, lo, hi)  # noqa: E731
    return VelState(left_y=d(margin, G - margin), right_y=d(margin, G - margin),
                    ball_x=d(x_margin, G - x_margin), ball_y=d(margin, G - margin),
                    vel_x=4 * d(0, 2) - 2, vel_y=4 * d(0, 2) - 2)


def _green_tail_render(left_y, right_y, ball_x, ball_y, vel_x, vel_y) -> torch.Tensor:
    """superpong/hardpong build_state: blue/red paddles and a green ball
    with a tail at (ball - velocity) (reference envs/superpong.py:78-103)."""
    bs = 2
    frame = _frame(left_y)
    _paddles(frame, left_y, right_y)
    bx = torch.clamp(ball_x, bs, G - bs)
    by = torch.clamp(ball_y, bs, G - bs)
    body = slice_rect_mask(G, G, by - bs, by + bs, bx - bs, bx + bs)
    tail_x, tail_y, ts = bx - vel_x, by - vel_y, bs - 1
    tail = slice_rect_mask(G, G, tail_y - 1, tail_y + 1, tail_x - ts, tail_x + ts)
    _paint(frame, 1, torch.maximum(body, tail))
    return frame


def superpong_step(state: VelState, action: torch.Tensor, noise=None):
    ph = 4
    d_left, d_right = _paddle_dy(action)
    left_y = state.left_y + d_left
    right_y = state.right_y + d_right
    ball_x = state.ball_x + state.vel_x
    ball_y = state.ball_y + state.vel_y
    vx, vy = state.vel_x, state.vel_y
    # a sequential if-chain (envs/superpong.py:57-66): each flip re-tests the
    # updated velocity, so the flips apply in order
    vx = torch.where((ball_x >= G - 3) & (vx > 0), -vx, vx)   # wall right
    vx = torch.where((ball_x <= 3) & (vx < 0), -vx, vx)       # wall left
    vx = torch.where((ball_x >= G - 5) & (vx > 0)             # right paddle
                     & (right_y - ph <= ball_y) & (ball_y <= right_y + ph), -vx, vx)
    vx = torch.where((ball_x <= 5) & (vx < 0)                 # left paddle
                     & (left_y - ph <= ball_y) & (ball_y <= left_y + ph), -vx, vx)
    vy = torch.where(((ball_y >= G - 1) & (vy > 0)) | ((ball_y <= 1) & (vy < 0)), -vy, vy)
    return VelState(left_y, right_y, ball_x, ball_y, vx, vy), *no_reward(ball_x)


def superpong_render(s: VelState) -> torch.Tensor:
    return _green_tail_render(s.left_y, s.right_y, s.ball_x, s.ball_y, s.vel_x, s.vel_y)


def _superpong_factors(z: torch.Tensor) -> torch.Tensor:
    v = torch.full_like(z[:, 0], 2, dtype=torch.int64)
    return _green_tail_render(*_positions(z), v, v)


@register("superpong")
def make_superpong() -> EnvSpec:
    return EnvSpec(
        name="superpong", num_actions=4, num_rewards=1, channels=CHANNELS, height=G,
        width=G, reset=vel_reset, draw_noise=draw_nothing, step=superpong_step,
        render=superpong_render, true_latent_dim=4,
        simulator=_simulator(_superpong_factors))


# ===========================================================================
# hardpong (reference envs/hardpong.py): superpong with clamped paddles, the
# paddle bounce at 8 / G-8 and the wall bounce at 2 / G-2.
# ===========================================================================

def hardpong_step(state: VelState, action: torch.Tensor, noise=None):
    ph = 4
    d_left, d_right = _paddle_dy(action)
    left_y = torch.clamp(state.left_y + d_left, 0, G)
    right_y = torch.clamp(state.right_y + d_right, 0, G)
    ball_x = state.ball_x + state.vel_x
    ball_y = state.ball_y + state.vel_y
    vx, vy = state.vel_x, state.vel_y
    # the sequential if-chain of envs/hardpong.py:59-68, in its order
    vx = torch.where((ball_x >= G - 8) & (vx > 0)             # right paddle
                     & (right_y - ph <= ball_y) & (ball_y <= right_y + ph), -vx, vx)
    vx = torch.where((ball_x <= 8) & (vx < 0)                 # left paddle
                     & (left_y - ph <= ball_y) & (ball_y <= left_y + ph), -vx, vx)
    vx = torch.where((ball_x >= G - 2) & (vx > 0), -vx, vx)   # wall right
    vx = torch.where((ball_x <= 2) & (vx < 0), -vx, vx)       # wall left
    vy = torch.where(((ball_y >= G - 2) & (vy > 0)) | ((ball_y <= 2) & (vy < 0)), -vy, vy)
    return VelState(left_y, right_y, ball_x, ball_y, vx, vy), *no_reward(ball_x)


@register("hardpong")
def make_hardpong() -> EnvSpec:
    return EnvSpec(
        name="hardpong", num_actions=4, num_rewards=1, channels=CHANNELS, height=G,
        width=G, reset=vel_reset, draw_noise=draw_nothing, step=hardpong_step,
        render=superpong_render, true_latent_dim=4,
        simulator=_simulator(_superpong_factors))


# ===========================================================================
# realpong (reference envs/realpong.py): betterpong's predecessor; the
# episode ENDS on a score; the ball is drawn with a direction tail by
# draw_rect.
# ===========================================================================

_REALPONG_VELOCITIES = (-3, -2, 2, 3)


def realpong_reset(batch_size: int, device=None,
                   generator: torch.Generator = None) -> VelState:
    d = lambda lo, hi: draw_ints(generator, batch_size, lo, hi)  # noqa: E731
    vels = torch.tensor(_REALPONG_VELOCITIES, dtype=torch.int64, device=generator.device)
    return VelState(left_y=d(4, G - 4), right_y=d(4, G - 4), ball_x=d(5, G - 5),
                    ball_y=d(4, G - 4), vel_x=vels[d(0, 4)], vel_y=vels[d(0, 4)])


def realpong_step(state: VelState, action: torch.Tensor, noise=None):
    pw, ph, br = 1, 4, 2
    mx = 5
    d_left, d_right = _paddle_dy(action)
    right_y = torch.clamp(state.right_y + d_right, 0, G)
    left_y = torch.clamp(state.left_y + d_left, 0, G)
    ball_x = state.ball_x + state.vel_x
    ball_y = state.ball_y + state.vel_y
    vx, vy = state.vel_x, state.vel_y
    bounce_right = G - mx - br - pw
    bounce_left = mx + br + pw
    # one-sided bounce windows (envs/realpong.py:56-66)
    hit_right = ((ball_x <= bounce_right + br) & (vx > 0)
                 & (right_y - ph <= ball_y) & (ball_y <= right_y + ph))
    hit_left = ((bounce_left - br <= ball_x) & (vx < 0)
                & (left_y - ph <= ball_y) & (ball_y <= left_y + ph))
    vx = torch.where(hit_right | hit_left, -vx, vx)
    vy = torch.where(((ball_y >= G - 2) & (vy > 0)) | ((ball_y <= 2) & (vy < 0)), -vy, vy)
    blue_scores = (ball_x >= G) & (vx > 0)
    red_scores = (ball_x <= 0) & (vx < 0)
    reward = torch.where(blue_scores, 1.0, torch.where(red_scores, -1.0, 0.0))
    return (VelState(left_y, right_y, ball_x, ball_y, vx, vy), reward[:, None],
            blue_scores | red_scores)


def realpong_render(s: VelState) -> torch.Tensor:
    pw, ph, br = 1, 4, 2
    mx = 5
    frame = _frame(s.ball_x)
    _paint(frame, 2, rect_mask(G, G, mx, s.left_y, pw, ph))
    _paint(frame, 0, rect_mask(G, G, G - mx, s.right_y, pw, ph))
    tail_x = torch.clamp(s.ball_x - s.vel_x, 0, G - 1)
    tail_y = torch.clamp(s.ball_y - s.vel_y, 0, G - 1)
    _paint(frame, 1, torch.maximum(rect_mask(G, G, s.ball_x, s.ball_y, br, br),
                                   rect_mask(G, G, tail_x, tail_y, br - 1, br - 1)))
    return frame


@register("realpong")
def make_realpong() -> EnvSpec:
    return EnvSpec(
        name="realpong", num_actions=4, num_rewards=1, channels=CHANNELS, height=G,
        width=G, reset=realpong_reset, draw_noise=draw_nothing, step=realpong_step,
        render=realpong_render)
