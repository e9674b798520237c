"""Datasource facade: the uniform trajectory-batch API.

Port of ``scmgan_tpu/data/datasource.py`` for the on-device synthetic envs
(``collect``, ``get_trajectories``, ``make_env``, ``convert_frame`` and
``allocate_datasource``, datasource.py:44-94), with the reference's four
channel-count attributes.  Host-process envs (ALE, SC2, gym) wait.
"""

from __future__ import annotations

from typing import Optional

import torch

from scmgan_tpu_torch.envs import EnvSpec, HostEnv, get_env, rollout
from scmgan_tpu_torch.utils.device import resolve_device


class Datasource:
    """Adapter over an EnvSpec, holding the generator its batches draw from."""

    def __init__(self, spec: EnvSpec, seed: int = 0, device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.binary_input_channels = spec.num_actions
        self.scalar_output_channels = spec.num_rewards
        self.conv_input_channels = spec.channels
        self.conv_output_channels = spec.channels

    def collect(self, batch_size: int, timesteps: int,
                generator: Optional[torch.Generator] = None,
                training: bool = True, policy: str = "random"):
        """(obs NHWC f32, rewards (B,T,R), dones (B,T), actions (B,T)) on the
        datasource's device.  ``training`` selects the replay split of
        host-process envs (reference main.py:791); synthetic envs make fresh
        trajectories either way."""
        if generator is None:
            generator = self.generator
        return rollout(self.spec, generator, batch_size, timesteps, policy)

    def get_trajectories(self, batch_size: int = 32, timesteps: int = 10,
                         policy: str = "random", random_start: bool = False,
                         training: bool = True):
        """Reference contract (e.g. envs/betterpong.py:116-137): states
        (B,T,C,H,W), rewards (B,T,R), dones (B,T), actions (B,T), as numpy.
        ``random_start``/``training`` are accepted for parity; synthetic envs
        ignore them like the reference does (envs/betterpong.py:115-116)."""
        obs, rewards, dones, actions = self.collect(batch_size, timesteps,
                                                    policy=policy)
        return (obs.permute(0, 1, 4, 2, 3).cpu().numpy(), rewards.cpu().numpy(),
                dones.cpu().numpy(), actions.cpu().numpy())

    def make_env(self, *args, **kwargs) -> HostEnv:
        """A ``HostEnv`` on the datasource's device, seeded from its generator
        (a fixed seed would make every MPC playthrough identical)."""
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.generator,
                                 device=self.device))
        return HostEnv(self.spec, seed=seed, device=self.device)

    def convert_frame(self, state):
        """(network_state, human_state) passthrough (reference
        datasource.py:33-35); ``HostEnv`` renders NHWC already."""
        return state, state


def allocate_datasource(name: str, seed: int = 0, device="cuda") -> Datasource:
    """String -> Datasource (reference datasource.py:8-26)."""
    return Datasource(get_env(name), seed=seed, device=device)
