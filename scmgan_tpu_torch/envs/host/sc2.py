"""StarCraft II host environments (StarIntruders + variants, ZerglingDefense,
MicroBattle).

Port of ``scmgan_tpu/envs/host/sc2.py``.  SC2 runs as a separate game
process driven over protobuf RPC (the reference uses the ``sc2env``
package, envs/sc2_star_intruders.py:31-33); it is a host-process
environment bridged to the trainer through the actor/replay machinery
(``scmgan_tpu_torch.data.replay``) exactly like the reference's daemon
threads (envs/sc2_star_intruders.py:36-151).

Map variants: the reference selects StarIntrudersVariantA/B/C by poking a
module global from the datasource registry (datasource.py:40-43,
sc2_star_intruders.py:20); here the map name is an explicit constructor
argument.

Per-game behavior reproduced (policies + preprocessing are pure functions,
held against the JAX package's on fake envs in
tests/test_torch_port_host_envs.py):
  * zergling_defense — 5 actions with a 90%-no-op default policy
    (reference envs/sc2_zergling_defense.py:52-55), 4 reward channels read
    from the step info dict (sc2_zergling_defense.py:84), feature-screen
    network frames (sc2_zergling_defense.py:147-150), 20-step trajectories.
  * micro_battle — 2 actions, rendered-RGB frames /255 downsampled by 2 in
    each spatial dim (envs/sc2_micro_battle.py:43-48), 3 warm-up no-op steps
    after reset (sc2_micro_battle.py:39-41), and the synchronous
    REPLAY_FACTOR=8 on-demand refill instead of a daemon actor
    (sc2_micro_battle.py:10,70-74).  (The reference never evicts buffer
    slot 0 — randint(1, LEN) at sc2_micro_battle.py:65 — which we treat as
    an off-by-one bug, not behavior to preserve.)

The sc2env dependency + SC2 binary are optional; the environment
*constructor* raises a clear ImportError when they are absent, but
datasource allocation and all policy/preprocessing code work without them.
"""

from __future__ import annotations

import numpy as np

from scmgan_tpu_torch.data.replay import HostReplayDatasource

SCREEN_SIZE = 64
ZERGLING_NOOP_ACTION = 4       # reference envs/sc2_zergling_defense.py:19
ZERGLING_NOOP_PROB = 0.9       # sc2_zergling_defense.py:52-55
ZERGLING_MAX_TRAJECTORY = 20   # sc2_zergling_defense.py:15
ZERGLING_NUM_REWARDS = 4       # sc2_zergling_defense.py:84 info-dict values
MICRO_BATTLE_REPLAY_FACTOR = 8   # sc2_micro_battle.py:10
MICRO_BATTLE_BUFFER_LEN = 500    # sc2_micro_battle.py:11
MICRO_BATTLE_MAX_TRAJECTORY = 100  # sc2_micro_battle.py:12
MICRO_BATTLE_WARMUP_STEPS = 3    # sc2_micro_battle.py:39-41

SC2_GAMES = {
    # name -> (game key, num_actions, num_rewards, channels)
    "sc2_star_intruders": ("star_intruders", 4, 2, 4),
    "sc2_star_intruders_variant_a": ("star_intruders", 4, 2, 4),
    "sc2_star_intruders_variant_b": ("star_intruders", 4, 2, 4),
    "sc2_star_intruders_variant_c": ("star_intruders", 4, 2, 4),
    "sc2_zergling_defense": ("zergling_defense", 5, 4, 4),
    "sc2_micro_battle": ("micro_battle", 2, 1, 3),
}

_VARIANT_MAPS = {
    "sc2_star_intruders": "StarIntruders",
    "sc2_star_intruders_variant_a": "StarIntrudersVariantA",
    "sc2_star_intruders_variant_b": "StarIntrudersVariantB",
    "sc2_star_intruders_variant_c": "StarIntrudersVariantC",
}


def _sc2_import_error(game: str, exc: Exception) -> ImportError:
    return ImportError(
        f"SC2 game {game!r} requires the sc2env package and a StarCraft II "
        f"installation; not available in this image ({exc!r}).")


def _make_star_intruders(map_name: str, screen_size: int = SCREEN_SIZE):
    try:
        from sc2env.environments.star_intruders import (
            StarIntrudersEnvironment,
        )
    except Exception as e:  # noqa: BLE001 - reported as the ImportError
        raise _sc2_import_error("star_intruders", e) from e
    return StarIntrudersEnvironment(map_name=map_name,
                                    screen_size=screen_size)


def _make_zergling_defense():
    """reference envs/sc2_zergling_defense.py:33."""
    try:
        from sc2env.environments.zergling_defense import (
            ZerglingDefenseEnvironment,
        )
    except Exception as e:  # noqa: BLE001 - reported as the ImportError
        raise _sc2_import_error("zergling_defense", e) from e
    return ZerglingDefenseEnvironment()


def _make_micro_battle():
    """reference envs/sc2_micro_battle.py:30 (render=True: the network
    consumes the rendered RGB screen)."""
    try:
        from sc2env.environments.micro_battle import MicroBattleEnvironment
    except Exception as e:  # noqa: BLE001 - reported as the ImportError
        raise _sc2_import_error("micro_battle", e) from e
    return MicroBattleEnvironment(render=True)


class NoopBiasedPolicy:
    """No-op with probability ``noop_prob``, else uniform-random action
    (reference envs/sc2_zergling_defense.py:52-55, which falls back to
    env.action_space.sample())."""

    def __init__(self, num_actions: int, noop_action: int,
                 noop_prob: float = ZERGLING_NOOP_PROB, seed: int = 0):
        self.num_actions = num_actions
        self.noop_action = noop_action
        self.noop_prob = noop_prob
        self._rng = np.random.default_rng(seed)

    def __call__(self, state=None) -> int:
        if self._rng.random() < self.noop_prob:
            return self.noop_action
        return int(self._rng.integers(0, self.num_actions))


def convert_frame(state):
    """SC2 feature-screen frames pass through as the network state; the
    RGB render is the human view (reference sc2_star_intruders.py:154-157).
    Here state is expected to be (features, rgb) or a feature array."""
    if isinstance(state, tuple) and len(state) == 2:
        return np.asarray(state[0], np.float32)
    return np.asarray(state, np.float32)


def zergling_convert_frame(state):
    """(feature_map, feature_screen, rgb_map, rgb_screen) -> feature_screen
    (reference envs/sc2_zergling_defense.py:147-150: the network consumes
    the feature screen; the /255 RGB render is the human view only)."""
    if isinstance(state, tuple) and len(state) == 4:
        return np.asarray(state[1], np.float32)
    return np.asarray(state, np.float32)


def zergling_split_reward(reward_sum, info):
    """The 4 reward channels are the values of the step's info dict
    (reference envs/sc2_zergling_defense.py:84)."""
    vec = np.asarray(list(info.values()), np.float32)
    if vec.shape != (ZERGLING_NUM_REWARDS,):
        # fail loud: an extra diagnostic key (or nested value) would
        # otherwise produce ragged reward rows deep in the stitcher
        raise ValueError(
            f"zergling info dict yields reward vector of shape {vec.shape}, "
            f"expected ({ZERGLING_NUM_REWARDS},); keys={list(info)}")
    return vec


def micro_battle_convert_frame(state):
    """Rendered game pixels (state[3], HWC uint8) -> CHW float in [0, 1],
    downsampled by 2 in each spatial dim
    (reference envs/sc2_micro_battle.py:43-48)."""
    frame = state[3] if isinstance(state, (tuple, list)) else state
    frame = np.asarray(frame, np.float32)
    frame = frame.transpose(2, 0, 1)  # HWC -> CHW
    frame = frame * (1.0 / 255.0)
    return frame[:, ::2, ::2]


class SC2Datasource(HostReplayDatasource):
    def __init__(self, name: str, seed: int = 0, device="cuda"):
        if name not in SC2_GAMES:
            raise ValueError(f"Unknown SC2 datasource {name!r}; "
                             f"available: {sorted(SC2_GAMES)}")
        game, num_actions, num_rewards, channels = SC2_GAMES[name]
        kwargs = dict(num_actions=num_actions, num_rewards=num_rewards,
                      channels=channels, seed=seed, name=name, device=device)

        if game == "star_intruders":
            map_name = _VARIANT_MAPS[name]

            def make_env(*args, screen_size: int = SCREEN_SIZE, **kw):
                return _make_star_intruders(map_name, screen_size)

            kwargs.update(convert_frame=convert_frame)
        elif game == "zergling_defense":
            def make_env(*args, **kw):
                return _make_zergling_defense()

            kwargs.update(
                convert_frame=zergling_convert_frame,
                split_reward=zergling_split_reward,
                policy=NoopBiasedPolicy(num_actions, ZERGLING_NOOP_ACTION,
                                        seed=seed),
                max_trajectory_len=ZERGLING_MAX_TRAJECTORY,
            )
        else:  # micro_battle
            def make_env(*args, **kw):
                return _make_micro_battle()

            kwargs.update(
                convert_frame=micro_battle_convert_frame,
                warmup_steps=MICRO_BATTLE_WARMUP_STEPS,
                warmup_action=0,
                max_trajectory_len=MICRO_BATTLE_MAX_TRAJECTORY,
                capacity=MICRO_BATTLE_BUFFER_LEN,
                sync_refill_factor=MICRO_BATTLE_REPLAY_FACTOR,
            )

        super().__init__(make_env=make_env, **kwargs)
