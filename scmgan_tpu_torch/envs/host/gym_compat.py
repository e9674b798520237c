"""gym / gymnasium compatibility shim.

Port of ``scmgan_tpu/envs/host/gym_compat.py``.  The reference drives the
legacy ``gym`` API everywhere: ``reset() -> obs`` and
``step(a) -> (obs, reward, done, info)`` (reference envs/gym_make.py:15-63,
envs/atari.py:40-66).  Modern images ship ``gymnasium`` instead, whose API
returns ``reset() -> (obs, info)`` and a 5-tuple
``(obs, reward, terminated, truncated, info)``.  This module exposes one
factory that yields legacy-API envs from whichever backend exists, so every
host adapter stays written against the reference's convention.
"""

from __future__ import annotations


class LegacyEnv:
    """Wrap a gymnasium env behind the legacy 4-tuple gym API."""

    def __init__(self, env):
        self._env = env

    def reset(self, **kwargs):
        out = self._env.reset(**kwargs)
        if isinstance(out, tuple):  # gymnasium: (obs, info)
            return out[0]
        return out

    def step(self, action):
        out = self._env.step(action)
        if len(out) == 5:  # gymnasium: terminated/truncated split
            obs, reward, terminated, truncated, info = out
            return obs, reward, bool(terminated or truncated), info
        return out

    def __getattr__(self, name):
        return getattr(self._env, name)


class _LegacyGymModule:
    """Module-like facade: ``.make(...)`` always returns a legacy-API env.

    Every env is wrapped: LegacyEnv adapts per call shape, so it is a
    passthrough on true legacy backends and an adapter on new-API ones.
    Deciding by package name instead would misread gym>=0.26, which ships
    the gymnasium-style API under the legacy package name."""

    def __init__(self, backend):
        self._backend = backend
        self.backend_name = backend.__name__

    def make(self, name: str, **kwargs):
        return LegacyEnv(self._backend.make(name, **kwargs))

    def __getattr__(self, name):
        return getattr(self._backend, name)


def import_gym() -> _LegacyGymModule:
    """Return a gym-like module, preferring legacy ``gym``, falling back to
    ``gymnasium``, either way wrapped behind the legacy API.  Raises
    ImportError when neither backend exists."""
    try:
        import gym

        return _LegacyGymModule(gym)
    except Exception:  # noqa: BLE001 - a broken gym install counts as absent, as in JAX
        pass
    try:
        import gymnasium

        return _LegacyGymModule(gymnasium)
    except Exception as e:  # noqa: BLE001 - reported as the ImportError below
        raise ImportError(
            f"neither gym nor gymnasium is available in this image ({e!r})"
        ) from e
