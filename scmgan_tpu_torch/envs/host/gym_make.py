"""Alternate Atari multi-environment with frameskip + 3-frame stacking.

Port of ``scmgan_tpu/envs/host/gym_make.py`` (parity with reference
envs/gym_make.py:14-150): a batched gym wrapper that steps each env 3x per
call (building a stacked 3-frame observation), resets Pong immediately on
any score, and applies the crop/block-reduce/binarize preprocessing
(``envs.host.atari``).

The reference notes ALE is not thread-safe (envs/gym_make.py:19-21) and
constructs envs serially; stepping also stays serial.
"""

from __future__ import annotations

import numpy as np

from scmgan_tpu_torch.envs.host.atari import convert_breakout, convert_pong


def _require_gym():
    from scmgan_tpu_torch.envs.host.gym_compat import import_gym

    return import_gym()


class MultiEnvironment:
    """Batched gym env with frameskip + 3-step frame stacking
    (reference envs/gym_make.py:15-63)."""

    def __init__(self, name: str, batch_size: int, frameskip: int = 2):
        gym = _require_gym()
        self.name = name
        self.batch_size = batch_size
        # ALE is non-threadsafe: construct serially (gym_make.py:19-21)
        self.envs = [gym.make(name) for _ in range(batch_size)]
        for env in self.envs:
            env.unwrapped.frameskip = frameskip
        self.reset()

    def reset(self):
        for env in self.envs:
            reset_env(env)

    def step(self, actions):
        results = [self._step_one(env, a)
                   for env, a in zip(self.envs, actions)]
        states, rewards, dones, infos = zip(*results)
        return states, rewards, dones, infos

    def _step_one(self, env, action):
        frames = []
        cumulative = 0.0
        done = False
        info = {}
        for _ in range(3):
            state, reward, done, info = env.step(action)
            # Pong: reset immediately on each score (gym_make.py:41-44)
            if done or reward:
                reset_env(env)
            cumulative += reward
            frames.append(state)
        convert = convert_pong if "Pong" in self.name else convert_breakout
        return convert(np.array(frames)), cumulative, done, info

    def __getattr__(self, name):
        return getattr(self.envs[0].unwrapped, name)


def reset_env(env):
    """Pong reset burn-in until the enemy paddle appears
    (reference envs/gym_make.py:59-63)."""
    env.reset()
    for _ in range(100):
        env.step(0)
