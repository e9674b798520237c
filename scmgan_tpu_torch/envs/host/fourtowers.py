"""FourTowers / SimpleTowers — SC2 offline dataset builder.

Port of ``scmgan_tpu/envs/host/fourtowers.py`` (parity with reference
envs/fourtowers.py:17-27, which builds an offline (before, action, after)
transition dataset from the SC2 SimpleTowers map).  SC2 is a host-process
dependency; building requires the sc2env package and a StarCraft II
install.
"""

from __future__ import annotations

import numpy as np


def build_dataset(size: int = 10_000, num_actions: int = 4,
                  map_name: str = "SimpleTowers"):
    """List of (before, action_onehot, after) transitions."""
    try:
        from sc2env.environments.simple_towers import SimpleTowersEnvironment
    except Exception as e:  # noqa: BLE001 - reported as the ImportError below
        raise ImportError(
            "fourtowers requires sc2env + StarCraft II; not available "
            f"({e!r})"
        ) from e

    env = SimpleTowersEnvironment(map_name=map_name)
    dataset = []
    state = env.reset()
    for _ in range(size):
        action = np.random.randint(num_actions)
        onehot = np.eye(num_actions, dtype=np.float32)[action]
        before = np.asarray(state)
        state, reward, done, info = env.step(action)
        dataset.append((before, onehot, np.asarray(state)))
        if done:
            state = env.reset()
    return dataset
