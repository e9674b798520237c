"""Environment registry.  Importing this package registers the ported envs."""

from scmgan_tpu_torch.envs.base import (  # noqa: F401
    EnvSpec,
    HostEnv,
    available_envs,
    get_env,
    register,
    rollout,
)
from scmgan_tpu_torch.envs import (  # noqa: F401
    betterpong,
    boxes,
    gameoflife,
    gridworld,
    minipacman,
    pong_family,
    roomba,
)
