"""GridWorld, batched over B on the device: a ball moved by 4 actions on a
16x16 court.

Port of ``scmgan_tpu/envs/gridworld.py`` (``reset``, ``step``, ``render``),
reference envs/gridworld.py:17-97: +-1 reward when the ball reaches the
right/left wall, no terminal state, no randomness in a step.  The start is
drawn from a generator.  ``simulator`` renders the Higgins metric's
two-factor frames (the ball's x and y).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scmgan_tpu_torch.envs.base import EnvSpec, register
from scmgan_tpu_torch.envs.raster import rect_mask

CHANNELS = 3
GAME_SIZE = 16
BALL_RADIUS = 2
NUM_ACTIONS = 4
NUM_REWARDS = 1
MARGIN_X = 2
MARGIN_Y = 2


class State(NamedTuple):
    ball_x: torch.Tensor  # (B,) int64
    ball_y: torch.Tensor  # (B,) int64


def reset(batch_size: int, device=None, generator: torch.Generator = None) -> State:
    """Uniform start positions, drawn from ``generator`` on its device."""
    if generator is None:
        raise ValueError("gridworld draws its start from a generator")
    draw = lambda lo, hi: torch.randint(lo, hi, (batch_size,), generator=generator,  # noqa: E731
                                        device=generator.device)
    return State(ball_x=draw(MARGIN_X, GAME_SIZE - MARGIN_X),
                 ball_y=draw(MARGIN_Y, GAME_SIZE - MARGIN_Y))


def draw_noise(batch_size: int, generator: torch.Generator):
    """A step draws nothing."""
    return None


def step(state: State, action: torch.Tensor, noise=None):
    # Actions: 0 up, 1 down, 2 left, 3 right (reference envs/gridworld.py:29-42).
    action = action.long()
    dy = torch.where(action == 0, -3, torch.where(action == 1, 3, 0))
    dx = torch.where(action == 2, -3, torch.where(action == 3, 3, 0))
    ball_y = torch.clamp(state.ball_y + dy, MARGIN_Y, GAME_SIZE - MARGIN_Y)
    ball_x = torch.clamp(state.ball_x + dx, 0, GAME_SIZE)
    reward = torch.where(ball_x >= GAME_SIZE, 1.0,
                         torch.where(ball_x <= 0, -1.0, 0.0))
    done = torch.zeros_like(ball_x, dtype=torch.bool)
    return State(ball_x, ball_y), reward[:, None], done


def render(state: State) -> torch.Tensor:
    b = state.ball_x.shape[0]
    frame = torch.zeros((b, GAME_SIZE, GAME_SIZE, CHANNELS), dtype=torch.float32,
                        device=state.ball_x.device)
    frame[..., 1] = rect_mask(GAME_SIZE, GAME_SIZE, state.ball_x, state.ball_y,
                              BALL_RADIUS, BALL_RADIUS)
    return frame


TRUE_LATENT_DIM = 2  # ball_x, ball_y


def simulator(factor_batch) -> np.ndarray:
    """Factors (B, 2) in [0, 1] -> rendered frames (B, H, W, C), for the
    Higgins metric (scmgan_tpu/envs/gridworld.py:64): the ball's x and y
    over the court between the margins, rounded as the JAX package rounds
    them (f32 arithmetic, then truncation).  Runs on the CPU."""
    z = torch.as_tensor(np.asarray(factor_batch, np.float32))
    x = (z[:, 0] * (GAME_SIZE - 2 * MARGIN_X) + MARGIN_X + 0.5).to(torch.int64)
    y = (z[:, 1] * (GAME_SIZE - 2 * MARGIN_Y) + MARGIN_Y + 0.5).to(torch.int64)
    return render(State(ball_x=x, ball_y=y)).numpy()


@register("gridworld")
def make_spec() -> EnvSpec:
    return EnvSpec(
        name="gridworld",
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
