"""BetterPong, the "pong" datasource, batched over B on the device: two
controllable paddles, a bouncing ball, +-1 reward on scoring, no terminal
state.

Port of ``scmgan_tpu/envs/betterpong.py`` (``reset``, ``step``, ``render``),
reference envs/betterpong.py:23-112, with the same integer dynamics: the
start velocities drawn from ``_VELOCITIES``, paddle, wall and score
reflections.  A step draws nothing.  The dynamics take any integer
velocity, as the reference's Higgins simulator needs: it seeds both
velocities from the left paddle's factor (envs/betterpong.py:164-165, the
velocity-seeding quirk), so they may be 0 or as large as the court.  ``simulator``
renders the Higgins metric's frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from scmgan_tpu_torch.envs.base import EnvSpec, draw_ints, register
from scmgan_tpu_torch.envs.raster import rect_mask

CHANNELS = 3
GAME_SIZE = 64
PADDLE_WIDTH = 1
PADDLE_HEIGHT = 8
BALL_RADIUS = 2
NUM_ACTIONS = 4
TRUE_LATENT_DIM = 6
NUM_REWARDS = 1
MARGIN_Y = 4
MARGIN_X = 5

_VELOCITIES = (-3, -2, 2, 3)


class State(NamedTuple):
    left_y: torch.Tensor   # (B,) int64
    right_y: torch.Tensor
    ball_x: torch.Tensor
    ball_y: torch.Tensor
    vel_x: torch.Tensor
    vel_y: torch.Tensor


def reset(batch_size: int, device=None, generator: torch.Generator = None) -> State:
    """Uniform paddles, ball and velocities, drawn from ``generator`` on its
    device in the order of the fields."""
    draw = lambda lo, hi: draw_ints(generator, batch_size, lo, hi)  # noqa: E731
    left_y = draw(MARGIN_Y, GAME_SIZE - MARGIN_Y)
    right_y = draw(MARGIN_Y, GAME_SIZE - MARGIN_Y)
    ball_x = draw(MARGIN_X, GAME_SIZE - MARGIN_X)
    ball_y = draw(MARGIN_Y, GAME_SIZE - MARGIN_Y)
    velocities = torch.tensor(_VELOCITIES, dtype=torch.int64, device=left_y.device)
    return State(left_y=left_y, right_y=right_y, ball_x=ball_x, ball_y=ball_y,
                 vel_x=velocities[draw(0, 4)], vel_y=velocities[draw(0, 4)])


def draw_noise(batch_size: int, generator: torch.Generator):
    """A step draws nothing."""
    return None


def step(state: State, action: torch.Tensor, noise=None):
    # Paddles (reference envs/betterpong.py:39-52): 0/1 move the right
    # paddle, 2/3 the left one.
    action = action.long()
    right_y = state.right_y + torch.where(action == 0, -3, torch.where(action == 1, 3, 0))
    right_y = torch.clamp(right_y, 0, GAME_SIZE)
    left_y = state.left_y + torch.where(action == 2, -3, torch.where(action == 3, 3, 0))
    left_y = torch.clamp(left_y, 0, GAME_SIZE)

    ball_x = state.ball_x + state.vel_x
    ball_y = state.ball_y + state.vel_y
    vel_x, vel_y = state.vel_x, state.vel_y

    # Paddle bounces (envs/betterpong.py:58-68).
    bounce_right = GAME_SIZE - MARGIN_X - BALL_RADIUS - PADDLE_WIDTH
    bounce_left = MARGIN_X + BALL_RADIUS + PADDLE_WIDTH
    hit_right = ((bounce_right <= ball_x) & (ball_x <= bounce_right + BALL_RADIUS)
                 & (vel_x > 0)
                 & (right_y - PADDLE_HEIGHT <= ball_y)
                 & (ball_y <= right_y + PADDLE_HEIGHT))
    hit_left = ((bounce_left - BALL_RADIUS <= ball_x) & (ball_x <= bounce_left)
                & (vel_x < 0)
                & (left_y - PADDLE_HEIGHT <= ball_y)
                & (ball_y <= left_y + PADDLE_HEIGHT))
    vel_x = torch.where(hit_right | hit_left, -vel_x, vel_x)

    # Wall bounces (envs/betterpong.py:70-74).
    vel_y = torch.where(((ball_y >= GAME_SIZE - 2) & (vel_y > 0))
                        | ((ball_y <= 2) & (vel_y < 0)), -vel_y, vel_y)

    # Scoring (envs/betterpong.py:76-87): the ball leaves the court -> +-1
    # and reflects back; the episode never terminates.
    blue_scores = (ball_x >= GAME_SIZE) & (vel_x > 0)
    red_scores = (ball_x <= 0) & (vel_x < 0)
    reward = torch.where(blue_scores, 1.0, torch.where(red_scores, -1.0, 0.0))
    vel_x = torch.where(blue_scores | red_scores, -vel_x, vel_x)

    done = torch.zeros_like(ball_x, dtype=torch.bool)
    return State(left_y, right_y, ball_x, ball_y, vel_x, vel_y), reward[:, None], done


def render(state: State) -> torch.Tensor:
    # Blue paddle left, red paddle right, green ball
    # (reference envs/betterpong.py:94-103; channels: 0=red, 1=green, 2=blue).
    b = state.ball_x.shape[0]
    frame = torch.zeros((b, GAME_SIZE, GAME_SIZE, CHANNELS), dtype=torch.float32,
                        device=state.ball_x.device)
    frame[..., 2] = rect_mask(GAME_SIZE, GAME_SIZE, MARGIN_X, state.left_y,
                              PADDLE_WIDTH, PADDLE_HEIGHT)
    frame[..., 0] = rect_mask(GAME_SIZE, GAME_SIZE, GAME_SIZE - MARGIN_X, state.right_y,
                              PADDLE_WIDTH, PADDLE_HEIGHT)
    frame[..., 1] = rect_mask(GAME_SIZE, GAME_SIZE, state.ball_x, state.ball_y,
                              BALL_RADIUS, BALL_RADIUS)
    return frame


def _rescale(z: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    # reference envs/betterpong.py:175-176, in f32 as the JAX package rounds
    return (z * (hi - lo) + lo + 0.5).to(torch.int64)


def simulator(factor_batch, actions: Optional[torch.Tensor] = None) -> np.ndarray:
    """Factors (B, 6) in [0, 1] -> three stacked frames a sample (B, 3, H, W,
    C), for the Higgins metric (scmgan_tpu/envs/betterpong.py:132; reference
    envs/betterpong.py:140-172): the state is set from the factors, then
    rendered and stepped three times under random actions.  Both ball
    velocities are seeded from the left paddle's factor, the reference's
    quirk (envs/betterpong.py:164-165).

    ``actions`` (B, 3): the actions of the three steps (the last one moves
    nothing that is rendered).  By default they are drawn from a generator
    seeded with 0, so that a batch of factors renders the same frames on
    every call, as the JAX package's fixed key does; a test passes the JAX
    package's actions.  Runs on the CPU."""
    z = torch.as_tensor(np.asarray(factor_batch, np.float32))
    b = z.shape[0]
    if actions is None:
        actions = torch.randint(0, NUM_ACTIONS, (b, 3),
                                generator=torch.Generator().manual_seed(0))
    actions = torch.as_tensor(actions, dtype=torch.int64)
    state = State(
        left_y=_rescale(z[:, 0], 0, GAME_SIZE),
        right_y=_rescale(z[:, 1], 0, GAME_SIZE),
        ball_x=_rescale(z[:, 2], MARGIN_X, GAME_SIZE - MARGIN_X),
        ball_y=_rescale(z[:, 3], MARGIN_Y, GAME_SIZE - MARGIN_Y),
        vel_x=_rescale(z[:, 0], 0, GAME_SIZE),
        vel_y=_rescale(z[:, 0], 0, GAME_SIZE),
    )
    frames = []
    for t in range(3):
        frames.append(render(state))
        state, _, _ = step(state, actions[:, t])
    return torch.stack(frames, dim=1).numpy()


@register("pong")
@register("betterpong")
def make_spec() -> EnvSpec:
    return EnvSpec(
        name="pong",
        num_actions=NUM_ACTIONS,
        num_rewards=NUM_REWARDS,
        channels=CHANNELS,
        height=GAME_SIZE,
        width=GAME_SIZE,
        reset=reset,
        draw_noise=draw_noise,
        step=step,
        render=render,
        true_latent_dim=TRUE_LATENT_DIM,
        simulator=simulator,
    )
