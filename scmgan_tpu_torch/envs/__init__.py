"""Environment registry.  Importing this package registers the ported envs."""

from scmgan_tpu_torch.envs.base import EnvSpec, HostEnv, get_env, register, rollout  # noqa: F401
from scmgan_tpu_torch.envs import betterpong, gridworld, minipacman  # noqa: F401
