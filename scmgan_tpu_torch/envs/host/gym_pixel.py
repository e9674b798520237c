"""Generic pixel-observation gym/gymnasium datasource.

Port of ``scmgan_tpu/envs/host/gym_pixel.py``.  The reference reaches
emulator games through gym adapters (reference envs/gym_make.py:14-150,
envs/atari.py:11-128) but hard-codes each game's preprocessing.  This
datasource generalizes that pattern to any discrete-action env whose
observations are RGB pixel arrays (e.g. gymnasium's CarRacing-v3): frames
are crop/nearest-resized to the model's 64x64 channels-first contract
(``envs.host.atari.crop_resize_64``) and played into the standard
actor/replay pipeline (``scmgan_tpu_torch.data.replay``), the same
host-to-card path the ALE/SC2 adapters use.

Allocated via ``allocate_datasource("gym:<EnvName>")``.
"""

from __future__ import annotations

from scmgan_tpu_torch.data.replay import HostReplayDatasource
from scmgan_tpu_torch.envs.host.atari import crop_resize_64
from scmgan_tpu_torch.envs.host.gym_compat import import_gym


def _make_discrete(gym_mod, name: str, **kwargs):
    """Build the env, coercing continuous-action games (CarRacing) into
    their discrete mode when one exists."""
    try:
        # A prior env's close() calls pygame.quit(), de-initializing the
        # font module that CarRacing's renderer needs; re-init is idempotent.
        import pygame

        pygame.font.init()
    except Exception:  # noqa: BLE001 - no pygame: nothing to re-init
        pass
    env = gym_mod.make(name, **kwargs)
    if hasattr(env.action_space, "n"):
        return env
    env.close()
    if "continuous" in kwargs:
        raise ValueError(f"{name} action space is not discrete")
    try:
        env = gym_mod.make(name, continuous=False, **kwargs)
    except TypeError as e:
        raise ValueError(
            f"{name} has a continuous action space and no discrete mode; "
            "the world model needs discrete actions"
        ) from e
    if not hasattr(env.action_space, "n"):
        env.close()
        raise ValueError(f"{name} has no discrete action mode")
    return env


class GymPixelDatasource(HostReplayDatasource):
    """Replay-buffer datasource over any discrete-action pixel gym env."""

    def __init__(self, name: str, seed: int = 0,
                 max_trajectory_len: int = 150, capacity: int = 50,
                 min_buffer_len: int = 4, make_kwargs: dict | None = None,
                 device="cuda"):
        gym_mod = import_gym()
        make_kwargs = dict(make_kwargs or {})
        probe = _make_discrete(gym_mod, name, **make_kwargs)
        obs_space = probe.observation_space
        if not (len(getattr(obs_space, "shape", ())) == 3
                and obs_space.shape[-1] == 3):
            probe.close()
            raise ValueError(
                f"{name} observations {getattr(obs_space, 'shape', None)} "
                "are not HxWx3 pixels; GymPixelDatasource needs a "
                "pixel-observation env")
        num_actions = probe.action_space.n
        probe.close()

        def make_env(*args, **kwargs):
            return _make_discrete(gym_mod, name, **make_kwargs)

        super().__init__(
            make_env=make_env,
            num_actions=num_actions,
            num_rewards=2,  # (positive, negative) split, the reference's
            # minipacman convention (envs/minipacman.py:104-106)
            channels=3,
            convert_frame=crop_resize_64,
            min_buffer_len=min_buffer_len,
            capacity=capacity,
            max_trajectory_len=max_trajectory_len,
            seed=seed,
            name=f"gym:{name}",
            device=device,
        )
        self.env_name = name
