"""MiniPacman, batched over B on the device.

Port of ``scmgan_tpu/envs/minipacman.py`` (``reset``, ``step``, ``render``):
a 16x16 maze rendered at 64x64 (4x4 px per cell, NHWC), 5 actions {NOOP,
RIGHT, UP, LEFT, DOWN}, 2 reward channels (positive, negative), rewards
{+1 food, +2 pill, +5 ghost eaten, -1 death}, done on all-food-eaten or
death.  The ghosts' randomness is the explicit ``Noise`` of each step: per
ghost a 5-way uniform on [0, 0.1) that breaks greedy ties, a 5-way uniform
that picks the random move, and one uniform that decides whether to explore.
The Higgins ``simulator`` waits.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from scmgan_tpu_torch.envs.base import EnvSpec, register

NUM_ACTIONS = 5   # NOOP, RIGHT, UP, LEFT, DOWN
NUM_REWARDS = 2
N = 16            # maze cells
SCALE = 4         # render upscale -> 64x64
G = N * SCALE
N_GHOSTS = 3
POWER_STEPS = 20

# Maze: '#' wall, '.' food, 'o' power pill, ' ' empty corridor.
_MAZE_STR = [
    "################",
    "#o.....##.....o#",
    "#.####.##.####.#",
    "#.#..........#.#",
    "#.#.###..###.#.#",
    "#...#......#...#",
    "#.#.#.#  #.#.#.#",
    "#.#...#..#...#.#",
    "#.#...#..#...#.#",
    "#.#.#.####.#.#.#",
    "#...#......#...#",
    "#.#.###..###.#.#",
    "#.#..........#.#",
    "#.####.##.####.#",
    "#o.....##.....o#",
    "################",
]
_WALLS = np.array([[c == "#" for c in row] for row in _MAZE_STR])
_FOOD0 = np.array([[c == "." for c in row] for row in _MAZE_STR])
_PILLS0 = np.array([[c == "o" for c in row] for row in _MAZE_STR])

# action -> (drow, dcol): NOOP, RIGHT, UP, LEFT, DOWN
_DR = (0, 0, -1, 0, 1)
_DC = (0, 1, 0, -1, 0)

_PACMAN_START = (12, 7)
_GHOST_STARTS = ((7, 7), (7, 8), (8, 8))
_CHASE_EXPLORE = 0.35  # ghosts pick a random legal move this often


class State(NamedTuple):
    pac_r: torch.Tensor     # (B,) int64
    pac_c: torch.Tensor     # (B,)
    ghost_r: torch.Tensor   # (B, N_GHOSTS)
    ghost_c: torch.Tensor   # (B, N_GHOSTS)
    food: torch.Tensor      # (B, N, N) bool
    pills: torch.Tensor     # (B, N, N) bool
    power: torch.Tensor     # (B,) int64 steps of ghost edibility remaining
    alive: torch.Tensor     # (B,) bool


class Noise(NamedTuple):
    tie: torch.Tensor       # (B, N_GHOSTS, NUM_ACTIONS) uniform [0, 0.1)
    move: torch.Tensor      # (B, N_GHOSTS, NUM_ACTIONS) uniform [0, 1)
    explore: torch.Tensor   # (B, N_GHOSTS) uniform [0, 1)


class _Tables(NamedTuple):
    walls: torch.Tensor
    food0: torch.Tensor
    pills0: torch.Tensor
    dr: torch.Tensor
    dc: torch.Tensor
    start_r: torch.Tensor
    start_c: torch.Tensor
    center2: torch.Tensor
    center3: torch.Tensor
    walls_px: torch.Tensor


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
    """The maze's constant tensors on ``device`` (made once per device)."""
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    center2 = np.zeros((SCALE, SCALE), np.float32)
    center2[1:3, 1:3] = 1.0
    center3 = np.zeros((SCALE, SCALE), np.float32)
    center3[1:4, 0:3] = 1.0
    walls_px = np.repeat(np.repeat(_WALLS, SCALE, 0), SCALE, 1)
    return _Tables(
        walls=t(_WALLS, torch.bool), food0=t(_FOOD0, torch.bool),
        pills0=t(_PILLS0, torch.bool),
        dr=t(_DR, torch.int64), dc=t(_DC, torch.int64),
        start_r=t([g[0] for g in _GHOST_STARTS], torch.int64),
        start_c=t([g[1] for g in _GHOST_STARTS], torch.int64),
        center2=t(center2, torch.float32), center3=t(center3, torch.float32),
        walls_px=t(walls_px, torch.float32))


def reset(batch_size: int, device, generator=None) -> State:
    """The fixed start (the generator is not drawn from)."""
    tb = _tables(torch.device(device))
    full = lambda v: torch.full((batch_size,), v, dtype=torch.int64,  # noqa: E731
                                device=tb.walls.device)
    return State(
        pac_r=full(_PACMAN_START[0]),
        pac_c=full(_PACMAN_START[1]),
        ghost_r=tb.start_r.expand(batch_size, N_GHOSTS).clone(),
        ghost_c=tb.start_c.expand(batch_size, N_GHOSTS).clone(),
        food=tb.food0.expand(batch_size, N, N).clone(),
        pills=tb.pills0.expand(batch_size, N, N).clone(),
        power=full(0),
        alive=torch.ones(batch_size, dtype=torch.bool, device=tb.walls.device),
    )


def draw_noise(batch_size: int, generator: torch.Generator) -> Noise:
    dev = generator.device
    shape = (batch_size, N_GHOSTS, NUM_ACTIONS)
    return Noise(
        tie=torch.rand(shape, generator=generator, device=dev) * 0.1,
        move=torch.rand(shape, generator=generator, device=dev),
        explore=torch.rand((batch_size, N_GHOSTS), generator=generator,
                           device=dev))


def _ghost_move(tb: _Tables, r, c, pac_r, pac_c, powered, noise: Noise):
    """Chase pacman greedily (flee while powered), explore at random
    ``_CHASE_EXPLORE`` of the time.  r, c: (B, G); pac_*, powered: (B,)."""
    cand_r = (r[..., None] + tb.dr).clamp(0, N - 1)            # (B, G, 5)
    cand_c = (c[..., None] + tb.dc).clamp(0, N - 1)
    legal = ~tb.walls[cand_r, cand_c]
    legal[..., 0] = False  # ghosts never stand still
    dist = ((cand_r - pac_r[:, None, None]).abs()
            + (cand_c - pac_c[:, None, None]).abs())
    objective = torch.where(powered[:, None, None], -dist, dist).to(torch.float32)
    neg_inf = torch.tensor(-torch.inf, device=r.device)
    greedy = torch.where(legal, -objective - noise.tie, neg_inf).argmax(-1)
    random_a = torch.where(legal, noise.move, neg_inf).argmax(-1)
    a = torch.where(noise.explore < _CHASE_EXPLORE, random_a, greedy)
    return (cand_r.gather(-1, a[..., None])[..., 0],
            cand_c.gather(-1, a[..., None])[..., 0])


def step(state: State, action: torch.Tensor, noise: Noise):
    tb = _tables(state.pac_r.device)
    action = action.long()
    pac_r = (state.pac_r + tb.dr[action]).clamp(0, N - 1)
    pac_c = (state.pac_c + tb.dc[action]).clamp(0, N - 1)
    blocked = tb.walls[pac_r, pac_c]
    pac_r = torch.where(blocked, state.pac_r, pac_r)
    pac_c = torch.where(blocked, state.pac_c, pac_c)

    # eat food / pill
    bidx = torch.arange(pac_r.shape[0], device=pac_r.device)
    got_food = state.food[bidx, pac_r, pac_c]
    got_pill = state.pills[bidx, pac_r, pac_c]
    food = state.food.clone()
    food[bidx, pac_r, pac_c] = False
    pills = state.pills.clone()
    pills[bidx, pac_r, pac_c] = False
    power = torch.where(got_pill, POWER_STEPS, (state.power - 1).clamp(min=0))
    powered = power > 0

    gr, gc = _ghost_move(tb, state.ghost_r, state.ghost_c, pac_r, pac_c,
                         powered, noise)

    # collisions (either side moving onto the other)
    collide = ((gr == pac_r[:, None]) & (gc == pac_c[:, None])) | (
        (state.ghost_r == pac_r[:, None]) & (state.ghost_c == pac_c[:, None]))
    eaten_ghosts = collide & powered[:, None]
    caught = (collide & ~powered[:, None]).any(-1)

    # eaten ghosts respawn at their start cells
    gr = torch.where(eaten_ghosts, tb.start_r, gr)
    gc = torch.where(eaten_ghosts, tb.start_c, gc)

    pos = (got_food.to(torch.float32) * 1.0
           + got_pill.to(torch.float32) * 2.0
           + eaten_ghosts.sum(-1).to(torch.float32) * 5.0)
    neg = torch.where(caught, -1.0, 0.0)
    reward = torch.stack([pos, neg], dim=-1)

    all_food_eaten = ~(food | pills).flatten(1).any(-1)
    done = caught | all_food_eaten
    new_state = State(pac_r, pac_c, gr, gc, food, pills, power,
                      state.alive & ~caught)
    return new_state, reward, done


def _dotscale(cells: torch.Tensor, dot: torch.Tensor) -> torch.Tensor:
    """(B, N, N) -> (B, G, G) placing ``dot`` (SCALE x SCALE) in occupied
    cells: a batched Kronecker product."""
    b = cells.shape[0]
    out = cells.to(torch.float32)[:, :, None, :, None] * dot[None, None, :, None, :]
    return out.reshape(b, G, G)


def _cell_mask(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(B, K) cell coordinates -> (B, G, G) float mask of those cells."""
    idx = torch.arange(N, device=rows.device)
    hit = ((rows[..., None, None] == idx[:, None])
           & (cols[..., None, None] == idx[None, :])).any(1)       # (B, N, N)
    return hit.to(torch.float32).repeat_interleave(SCALE, 1).repeat_interleave(SCALE, 2)


def render(state: State) -> torch.Tensor:
    tb = _tables(state.pac_r.device)
    b = state.pac_r.shape[0]
    zeros = torch.zeros((b, G, G), dtype=torch.float32, device=state.pac_r.device)
    red, green, blue = zeros, zeros, tb.walls_px * 0.5 + zeros

    food = _dotscale(state.food, tb.center2)
    green = torch.maximum(green, food)
    pills = _dotscale(state.pills, tb.center3)
    red, green, blue = (torch.maximum(ch, pills) for ch in (red, green, blue))

    pac_px = _cell_mask(state.pac_r[:, None], state.pac_c[:, None])
    red = torch.maximum(red, pac_px)
    green = torch.maximum(green, pac_px)

    ghost_px = _cell_mask(state.ghost_r, state.ghost_c)
    powered = (state.power > 0).to(torch.float32)[:, None, None]
    red = torch.maximum(red, ghost_px * torch.clamp(1.0 - powered, min=0.3))
    blue = torch.maximum(blue, ghost_px * powered)
    return torch.stack([red, green, blue], dim=-1)


@register("minipacman")
def make_spec() -> EnvSpec:
    return EnvSpec(
        name="minipacman",
        num_actions=NUM_ACTIONS,
        num_rewards=NUM_REWARDS,
        channels=3,
        height=G,
        width=G,
        reset=reset,
        draw_noise=draw_noise,
        step=step,
        render=render,
    )
