"""Centipede via a direct ALE interface: 2-step act with pixel-max
deflicker, 96x64 crop, and a shoot-biased heuristic policy.

Port of ``scmgan_tpu/envs/host/centipede.py`` (parity with reference
envs/centipede.py:8-114, which drives atari_py.ALEInterface directly and
benchmarks simulation throughput in its __main__).  The module-load-time
global env pool of the reference (centipede.py:70-72) becomes lazy
construction.
"""

from __future__ import annotations

import time

import numpy as np


def _require_ale():
    try:
        import atari_py

        return atari_py
    except Exception as e:  # noqa: BLE001 - reported as the ImportError below
        raise ImportError(
            f"centipede requires atari_py (ALE); not available ({e!r})"
        ) from e


class CentipedeEnv:
    NUM_ACTIONS = 18

    def __init__(self):
        atari_py = _require_ale()
        self.ale = atari_py.ALEInterface()
        self.ale.loadROM(atari_py.get_game_path("centipede"))
        self.action_space = _ActionSpace(self.NUM_ACTIONS)

    def reset(self):
        self.ale.reset_game()
        return self._observe()

    def step(self, action):
        # two-step act + pixel-max deflicker (reference centipede.py:29-41)
        reward = self.ale.act(action)
        frame_a = self.ale.getScreenRGB2()
        reward += self.ale.act(action)
        frame_b = self.ale.getScreenRGB2()
        frame = np.maximum(frame_a, frame_b)
        done = self.ale.game_over()
        return self._crop(frame), reward, done, {"lives": self.ale.lives()}

    def _observe(self):
        return self._crop(self.ale.getScreenRGB2())

    @staticmethod
    def _crop(frame):
        """96x64 crop region (reference centipede.py:44-50)."""
        frame = np.asarray(frame, np.float32) / 255.0
        h, w = frame.shape[:2]
        rows = (np.arange(96) * h // 96).clip(0, h - 1)
        cols = (np.arange(64) * w // 64).clip(0, w - 1)
        return frame[rows][:, cols]


class _ActionSpace:
    def __init__(self, n):
        self.n = n

    def sample(self):
        return np.random.randint(self.n)


class HeuristicPolicy:
    """Shoot-biased policy (reference centipede.py:53-67): mostly FIRE,
    with occasional random movement."""

    FIRE = 1

    def __init__(self, shoot_prob: float = 0.7, num_actions: int = 18,
                 seed: int = 0):
        self.shoot_prob = shoot_prob
        self.num_actions = num_actions
        self._rng = np.random.default_rng(seed)

    def __call__(self, state=None):
        if self._rng.random() < self.shoot_prob:
            return self.FIRE
        return int(self._rng.integers(0, self.num_actions))


class CentipedeDatasource:
    """Replay-buffer datasource over CentipedeEnv with the shoot-biased
    heuristic policy (reference envs/centipede.py:53-72)."""

    def __new__(cls, name: str = "centipede", seed: int = 0, device="cuda"):
        _require_ale()  # fail on the dependency before building machinery
        from scmgan_tpu_torch.data.replay import HostReplayDatasource

        policy = HeuristicPolicy(seed=seed)
        return HostReplayDatasource(
            make_env=lambda *a, **k: CentipedeEnv(),
            num_actions=CentipedeEnv.NUM_ACTIONS,
            num_rewards=2,
            channels=3,
            convert_frame=lambda s: np.moveaxis(s, -1, 0),
            policy=lambda state: policy(state),
            seed=seed,
            name=name, height=96, width=64,
            device=device,
        )


def benchmark(steps: int = 200):
    """Simulation-time benchmark (reference centipede.py:96-114)."""
    env = CentipedeEnv()
    policy = HeuristicPolicy()
    env.reset()
    start = time.time()
    for _ in range(steps):
        _, _, done, _ = env.step(policy())
        if done:
            env.reset()
    dt = time.time() - start
    print(f"{steps} steps in {dt:.2f}s ({steps / dt:.1f} steps/sec)")
    return steps / dt
