"""Roomba, batched over B on the device: a robot pushes a ball, +1 reward
on a push.

Port of ``scmgan_tpu/envs/roomba.py`` (reference envs/roomba1.py:18-87).
4 actions move the robot left/right/up/down by 3; a robot in contact with
the ball along the axis it moves on shoves the ball ahead of itself and
earns +1.  The robot is clamped to the court; the ball is NOT (the
reference's behaviour: it can be pushed off the screen).  A step draws
nothing and no episode ends.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scmgan_tpu_torch.envs.base import EnvSpec, draw_ints, draw_nothing, register
from scmgan_tpu_torch.envs.raster import rect_mask

G = 64
BALL_RADIUS = 3
ROBOT_RADIUS = 4
MARGIN_Y = 4
MARGIN_X = 5
SPEED = 3
RADIUS = BALL_RADIUS + ROBOT_RADIUS


class State(NamedTuple):
    robot_x: torch.Tensor  # (B,) int64
    robot_y: torch.Tensor
    ball_x: torch.Tensor
    ball_y: torch.Tensor


def reset(batch_size: int, device=None, generator: torch.Generator = None) -> State:
    """Robot anywhere between the margins, ball near the centre, drawn from
    ``generator`` on its device."""
    draw = lambda lo, hi: draw_ints(generator, batch_size, lo, hi)  # noqa: E731
    return State(robot_x=draw(MARGIN_X, G - MARGIN_X), robot_y=draw(MARGIN_Y, G - MARGIN_Y),
                 ball_x=draw(32 - 10, 32 + 10), ball_y=draw(32 - 10, 32 + 10))


def step(state: State, action: torch.Tensor, noise=None):
    action = action.long()
    rx, ry = state.robot_x, state.robot_y
    bx, by = state.ball_x, state.ball_y

    y_contact = (by - RADIUS < ry) & (ry < by + RADIUS)
    x_contact = (bx - RADIUS < rx) & (rx < bx + RADIUS)
    # a push: the robot moves into the ball from within radius + speed
    push_l = (action == 0) & y_contact & (bx <= rx) & (rx <= bx + RADIUS + SPEED)
    push_r = (action == 1) & y_contact & (bx - RADIUS - SPEED <= rx) & (rx <= bx)
    push_u = (action == 2) & x_contact & (by <= ry) & (ry <= by + RADIUS + SPEED)
    push_d = (action == 3) & x_contact & (by - RADIUS - SPEED <= ry) & (ry <= by)

    bx = torch.where(push_l, rx - SPEED - RADIUS, torch.where(push_r, rx + SPEED + RADIUS, bx))
    by = torch.where(push_u, ry - SPEED - RADIUS, torch.where(push_d, ry + SPEED + RADIUS, by))

    dx = torch.where(action == 0, -SPEED, torch.where(action == 1, SPEED, 0))
    dy = torch.where(action == 2, -SPEED, torch.where(action == 3, SPEED, 0))
    rx = torch.clamp(rx + dx, MARGIN_X, G - MARGIN_X)
    ry = torch.clamp(ry + dy, MARGIN_Y, G - MARGIN_Y)

    reward = (push_l | push_r | push_u | push_d).to(torch.float32)
    return State(rx, ry, bx, by), reward[:, None], torch.zeros_like(push_l)


def render(state: State) -> torch.Tensor:
    """Blue robot, red ball."""
    b = state.robot_x.shape[0]
    frame = torch.zeros((b, G, G, 3), dtype=torch.float32, device=state.robot_x.device)
    frame[..., 2] = rect_mask(G, G, state.robot_x, state.robot_y, ROBOT_RADIUS, ROBOT_RADIUS)
    frame[..., 0] = rect_mask(G, G, state.ball_x, state.ball_y, BALL_RADIUS, BALL_RADIUS)
    return frame


@register("roomba")
@register("roomba1")
def make_spec() -> EnvSpec:
    return EnvSpec(
        name="roomba", num_actions=4, num_rewards=1, channels=3, height=G, width=G,
        reset=reset, draw_noise=draw_nothing, step=step, render=render)
