"""ALE / Atari host environments.

Port of ``scmgan_tpu/envs/host/atari.py``.  The ALE emulator is host-side
C++ (loaded via atari_py/gym in the reference, envs/atari.py:11-128,
envs/centipede.py:8-72); it runs behind the generic actor/replay machinery
(``scmgan_tpu_torch.data.replay``), the reference's architecture: a daemon
thread plays SpaceInvaders episodes (50-frame burn-in, crop + 64x64
resize) into a replay buffer the trainer samples from.

The gym/atari dependency is optional; allocation raises a clear error when
absent.  Frame preprocessing (crop, block-reduce, binarize — reference
envs/gym_make.py:36-52,66-86) is dependency-free numpy below, exact in f32.
"""

from __future__ import annotations

import numpy as np

from scmgan_tpu_torch.data.replay import HostReplayDatasource


def block_reduce_max(frame: np.ndarray, block: int) -> np.ndarray:
    """Max-pool downsample (replaces skimage block_reduce,
    reference envs/gym_make.py:46,79)."""
    h, w = frame.shape
    h2, w2 = h // block, w // block
    return frame[: h2 * block, : w2 * block].reshape(
        h2, block, w2, block).max(axis=(1, 3))


def convert_pong(img_sequence: np.ndarray) -> np.ndarray:
    """Pong preprocessing (reference envs/gym_make.py / atari convert_pong):
    monochrome, crop rows 34:-16, 4x4 max-reduce, binarize."""
    pixels = np.asarray(img_sequence, np.float32).mean(-1)
    pixels = pixels[:, 34:-16, :]
    pixels = np.stack([block_reduce_max(f, 4) for f in pixels])
    pixels -= pixels.min()
    pixels[pixels > 0] = 1.0
    return pixels


def convert_breakout(img_sequence: np.ndarray) -> np.ndarray:
    """Breakout preprocessing (reference envs/gym_make.py:76-86)."""
    pixels = np.asarray(img_sequence, np.float32).mean(-1)
    pixels = pixels[:, 50:, :]
    pixels = np.stack([block_reduce_max(f, 2) for f in pixels])
    pixels -= pixels.min()
    pixels[pixels > 0] = 1.0
    return pixels


def crop_resize_64(rgb: np.ndarray) -> np.ndarray:
    """SpaceInvaders-style crop + nearest 64x64 resize (reference
    envs/atari.py crop/resize behavior), channels-first output."""
    frame = np.asarray(rgb, np.float32) / 255.0
    h, w = frame.shape[:2]
    rows = (np.arange(64) * h // 64).clip(0, h - 1)
    cols = (np.arange(64) * w // 64).clip(0, w - 1)
    small = frame[rows][:, cols]
    return np.moveaxis(small, -1, 0)


def _require_gym_atari():
    """Legacy gym first (SpaceInvadersDeterministic-v4), then gymnasium's
    ALE namespace (ALE/SpaceInvaders-v5 needs ale_py)."""
    from scmgan_tpu_torch.envs.host.gym_compat import import_gym

    try:
        gym_mod = import_gym()
        for name in ("SpaceInvadersDeterministic-v4", "ALE/SpaceInvaders-v5"):
            try:
                return gym_mod, gym_mod.make(name), name
            except Exception:  # noqa: BLE001 - try the next registration
                continue
        raise ImportError("no SpaceInvaders registration found")
    except Exception as e:  # noqa: BLE001 - reported as the ImportError below
        raise ImportError(
            "Atari support requires gym/gymnasium with atari_py / ale_py "
            f"installed; not available in this image ({e!r})."
        ) from e


class AtariDatasource(HostReplayDatasource):
    """SpaceInvaders replay-buffer datasource (reference envs/atari.py)."""

    def __init__(self, name: str = "atari", seed: int = 0, device="cuda"):
        gym, probe_env, reg_name = _require_gym_atari()
        num_actions = probe_env.action_space.n
        probe_env.close()

        def make_env(*args, **kwargs):
            env = gym.make(reg_name)
            return _BurnInWrapper(env, burn_in=50)

        super().__init__(
            make_env=make_env,
            num_actions=num_actions,
            num_rewards=2,
            channels=3,
            convert_frame=crop_resize_64,
            seed=seed,
            name=name,
            device=device,
        )


class _BurnInWrapper:
    """reset() burn-in of no-ops (reference envs/atari.py:60-62)."""

    def __init__(self, env, burn_in: int = 50):
        self._env = env
        self._burn_in = burn_in
        self.action_space = env.action_space

    def reset(self):
        state = self._env.reset()
        for _ in range(self._burn_in):
            state, *_ = self._env.step(0)
        return state

    def step(self, action):
        return self._env.step(action)

    def close(self):
        self._env.close()
