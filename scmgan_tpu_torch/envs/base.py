"""Environment protocol and batched on-device trajectory collection.

Port of ``scmgan_tpu/envs/base.py``.  The JAX package writes each synthetic
environment as pure per-env functions and vmaps them; the port writes them
batched over a leading B axis of tensors on the device:

    reset(batch_size, device, generator) -> state
    draw_noise(batch_size, generator)    -> the step's randomness
    step(state, actions, noise)          -> (state, rewards (B, R), dones (B,))
    render(state)                        -> obs (B, H, W, C) float32
    simulator(factors)                   -> frames for the Higgins metric

The step's randomness is an explicit argument, so a test can inject the
numbers that the JAX package's keys produce; a random start (gridworld,
pong) is drawn from the generator, and a test injects a start state
instead.  ``HostEnv`` steps one environment at a time for the play loop.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from scmgan_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """A batched environment definition."""

    name: str
    num_actions: int
    num_rewards: int
    channels: int
    height: int
    width: int
    reset: Callable[[int, torch.device, Optional[torch.Generator]], Any]
    draw_noise: Callable[[int, torch.Generator], Any]
    step: Callable[[Any, torch.Tensor, Any], tuple]
    render: Callable[[Any], torch.Tensor]
    true_latent_dim: Optional[int] = None
    # factors (B, true_latent_dim) in [0, 1] -> frames (numpy) for the
    # Higgins metric (reference envs/betterpong.py:140-172)
    simulator: Optional[Callable[[np.ndarray], np.ndarray]] = None

    @property
    def obs_shape(self):
        return (self.height, self.width, self.channels)


_REGISTRY: Dict[str, Callable[[], EnvSpec]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_env(name: str) -> EnvSpec:
    """Registry lookup (replaces the reference's if/elif chain,
    datasource.py:8-26)."""
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown environment {name!r}. Available: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def available_envs():
    """The registered names, sorted."""
    return sorted(_REGISTRY)


def _start_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise ValueError("a random start is drawn from a generator; pass one, "
                         "or inject the start state")
    return generator


def draw_ints(generator: torch.Generator, batch_size: int, lo: int, hi: int):
    """(B,) int64 uniform in [lo, hi), drawn from ``generator`` on its device."""
    g = _start_generator(generator)
    return torch.randint(lo, hi, (batch_size,), generator=g, device=g.device)


def draw_uniform(generator: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    """f32 uniform in [lo, hi) of ``shape``, drawn from ``generator`` on its
    device."""
    g = _start_generator(generator)
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=g.device)


def draw_nothing(batch_size: int, generator: torch.Generator):
    """``draw_noise`` of an env whose step draws nothing."""
    return None


def no_reward(like: torch.Tensor):
    """The zero reward (B, 1) and never-done flags (B,) of an env with no
    reward and no end, on ``like``'s (B, ...) device."""
    b = like.shape[0]
    return (torch.zeros((b, 1), dtype=torch.float32, device=like.device),
            torch.zeros(b, dtype=torch.bool, device=like.device))


def _policy_actions(spec: EnvSpec, generator: torch.Generator, batch: int,
                    policy: str) -> torch.Tensor:
    """The collection policy's actions: uniformly random, or ``repeat``
    (env i always takes action i mod A, drawing nothing)."""
    if policy == "repeat":
        return torch.arange(batch, device=generator.device) % spec.num_actions
    if policy == "random":
        return torch.randint(0, spec.num_actions, (batch,), generator=generator,
                             device=generator.device)
    raise ValueError(f"unknown policy {policy!r}: 'random' or 'repeat'")


def rollout(spec: EnvSpec, generator: torch.Generator, batch_size: int,
            timesteps: int, policy: str = "random"):
    """Collect a trajectory batch under ``policy`` (``_policy_actions``), on
    ``generator``'s device.

    Returns (obs, rewards, dones, actions) with shapes (B, T, H, W, C)
    float32, (B, T, R) float32, (B, T) bool, (B, T) int64.  Finished
    episodes auto-reset (reference multi_env.py:30-34).
    """
    device = generator.device
    state = spec.reset(batch_size, device, generator)
    actions = _policy_actions(spec, generator, batch_size, policy)
    obs = torch.empty((batch_size, timesteps) + spec.obs_shape,
                      dtype=torch.float32, device=device)
    rewards = torch.empty((batch_size, timesteps, spec.num_rewards),
                          dtype=torch.float32, device=device)
    dones = torch.empty((batch_size, timesteps), dtype=torch.bool,
                        device=device)
    emitted = torch.empty((batch_size, timesteps), dtype=torch.int64,
                          device=device)
    for t in range(timesteps):
        noise = spec.draw_noise(batch_size, generator)
        state, rewards[:, t], dones[:, t] = spec.step(state, actions, noise)
        obs[:, t] = spec.render(state)
        fresh = spec.reset(batch_size, device, generator)
        done = dones[:, t]
        state = type(state)(*(
            torch.where(done.view((-1,) + (1,) * (new.ndim - 1)), f, new)
            for new, f in zip(state, fresh)))
        actions = _policy_actions(spec, generator, batch_size, policy)
        # Emit the NEXT action, not the one just applied: the reference's
        # collection loop records at index t the action chosen after seeing
        # state t, so obs[t+1] = step(obs[t], actions[t])
        # (scmgan_tpu/envs/base.py:135-150, reference envs/gridworld.py:77-92).
        emitted[:, t] = actions
    return obs, rewards, dones, emitted


class HostEnv:
    """A gym-like adapter that steps one environment (B = 1) on ``device``,
    for the play loop (reference main.py:327-400).  Its randomness comes from
    a ``torch.Generator`` seeded with ``seed``, in place of the JAX
    package's key chain; ``start_state`` (a B = 1 state) replaces the first
    reset's draw, so a test can replay an episode of the JAX package."""

    def __init__(self, spec: EnvSpec, seed: int = 0, device="cuda",
                 start_state=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._start = start_state
        self.state = None

    def _obs(self) -> np.ndarray:
        return self.spec.render(self.state)[0].cpu().numpy()

    def reset(self) -> np.ndarray:
        if self._start is not None:
            self.state, self._start = self._start, None
        else:
            self.state = self.spec.reset(1, self.device, self.generator)
        return self._obs()

    def step(self, action: int):
        """(obs (H, W, C), summed reward, done, per-channel rewards); a
        finished episode resets."""
        a = torch.tensor([action], dtype=torch.int64, device=self.device)
        self.state, reward, done = self.spec.step(
            self.state, a, self.spec.draw_noise(1, self.generator))
        obs = self._obs()
        reward = reward[0].cpu().numpy()
        info = {f"reward_{i}": float(r) for i, r in enumerate(reward)}
        done = bool(done[0])
        if done:
            self.state = self.spec.reset(1, self.device, self.generator)
        return obs, float(reward.sum()), done, info
