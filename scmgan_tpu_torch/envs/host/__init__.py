"""Host-process environments (ALE Atari, StarCraft II, gym pixel games).

Port of ``scmgan_tpu/envs/host``.  These run as external processes or
emulators on the host, bridged to the training loop on the card through
background actor threads filling a replay buffer (the reference pattern:
envs/minipacman.py:50-164, envs/atari.py:11-128,
envs/sc2_star_intruders.py:12-151).  The actor/replay machinery lives in
``scmgan_tpu_torch.data.replay``; this package wires specific game backends
to it.

The external game backends (gym / gymnasium, atari_py / ale_py, sc2env) are
optional dependencies that are not present in every image; allocation
raises a clear error when a backend is unavailable, never falls back.
"""

from __future__ import annotations


def allocate_host_datasource(name: str, seed: int = 0, device="cuda"):
    if name == "atari":
        from scmgan_tpu_torch.envs.host.atari import AtariDatasource

        return AtariDatasource(name, seed=seed, device=device)
    if name == "centipede":
        from scmgan_tpu_torch.envs.host.centipede import CentipedeDatasource

        return CentipedeDatasource(name, seed=seed, device=device)
    if name.startswith("gym:"):
        from scmgan_tpu_torch.envs.host.gym_pixel import GymPixelDatasource

        return GymPixelDatasource(name.split(":", 1)[1], seed=seed, device=device)
    if name.startswith("sc2_"):
        from scmgan_tpu_torch.envs.host.sc2 import SC2Datasource

        return SC2Datasource(name, seed=seed, device=device)
    raise ValueError(f"Unknown host datasource {name!r}")
