"""Conway's Game of Life on a 64x64 torus, batched over B on the device: a
zero-player, zero-reward env with one action.

Port of ``scmgan_tpu/envs/gameoflife.py`` (reference envs/gameoflife.py,
which steps with scipy ``convolve2d(boundary='wrap')``).  The neighbour
count is the sum of the eight ``torch.roll`` shifts of the grid: small
integers, exact in any order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scmgan_tpu_torch.envs.base import (EnvSpec, draw_nothing, draw_uniform, no_reward,
                                        register)

CHANNELS = 1
GAME_SIZE = 64
NUM_ACTIONS = 1
NUM_REWARDS = 1


class State(NamedTuple):
    grid: torch.Tensor  # (B, H, W) bool


def reset(batch_size: int, device=None, generator: torch.Generator = None,
          p: float = 0.5) -> State:
    """Each cell alive where a uniform draw exceeds ``p`` (reference
    envs/gameoflife.py:23-25), drawn from ``generator`` on its device."""
    return State(grid=draw_uniform(generator, (batch_size, GAME_SIZE, GAME_SIZE)) > p)


def neighbours(grid: torch.Tensor) -> torch.Tensor:
    """(B, H, W) live-neighbour counts on the torus."""
    g = grid.to(torch.int32)
    return sum(torch.roll(g, (dy, dx), dims=(1, 2))
               for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0))


def step(state: State, action: torch.Tensor, noise=None):
    n = neighbours(state.grid)
    alive = (n == 3) | (state.grid & (n == 2))
    return (State(grid=alive), *no_reward(alive))


def render(state: State) -> torch.Tensor:
    return state.grid.to(torch.float32)[..., None]


@register("gameoflife")
def make_spec() -> EnvSpec:
    return EnvSpec(
        name="gameoflife", num_actions=NUM_ACTIONS, num_rewards=NUM_REWARDS,
        channels=CHANNELS, height=GAME_SIZE, width=GAME_SIZE, reset=reset,
        draw_noise=draw_nothing, step=step, render=render)
