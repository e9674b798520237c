"""Replay buffer + background actor for host-process environments.

Port of ``scmgan_tpu/data/replay.py``, which generalizes the reference's
per-env copy-pasted pattern (reference envs/minipacman.py:12-164,
envs/atari.py:11-128, envs/sc2_star_intruders.py:12-151) into one reusable
component:

  * a daemon actor thread plays episodes forever and fills the buffer
    (envs/minipacman.py:50-71)
  * 80/20 train/test split buffers (envs/minipacman.py:112-119)
  * reservoir-style random replacement beyond capacity
    (envs/minipacman.py:115-119)
  * environment recycled every MAX_EPISODES_PER_ENVIRONMENT episodes to
    flush emulator leaks (envs/minipacman.py:68-70)
  * actor-liveness check that raises in the trainer
    (envs/minipacman.py:126-128)
  * blocking wait until MIN_REPLAY_BUFFER_LEN episodes exist
    (envs/minipacman.py:133-136)
  * trajectory-clip stitching to exactly ``timesteps`` steps with a
    synthetic done at clip joins (envs/minipacman.py:139-164)

Buffers are guarded by a lock instead of relying on the GIL over bare-list
mutation (SURVEY §5 race note).

Divergences by design from the JAX module:

  * ``get_trajectories`` always stitches with the native C stitcher
    (``scmgan_tpu_torch.native``); a stitcher that cannot be built raises.
    The JAX module drops silently back to its Python loop when its native
    module fails to import.  The Python loop stays here as the plain
    version (``get_trajectories_plain``), which the tests hold against
    JAX's loop and the stitcher against.
  * ``collect(generator=...)`` reseeds the clip-sampling stream from one
    draw of ``generator``: a non-negative int64 seeds
    ``np.random.default_rng``.  The JAX module reseeds from the bits of its
    key.  With no generator neither reseeds, so the same buffers and seed
    give the same batches in both packages.
"""

from __future__ import annotations

import math
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from scmgan_tpu_torch.utils.device import resolve_device

Episode = Tuple[np.ndarray, np.ndarray, np.ndarray]  # states, rewards, actions


class ReplayBuffer:
    def __init__(self, capacity: int = 50, test_holdout: float = 0.20,
                 seed: int = 0):
        self.capacity = capacity
        self.test_holdout = test_holdout
        self._train: List[Episode] = []
        self._test: List[Episode] = []
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(seed)
        # bumped on every mutation; lets consumers cache derived views
        # (the stitch arena) instead of rebuilding per sample.  Per-slot
        # versions let them copy in only the episodes that changed.
        self.version = 0
        self._train_slot_versions: List[int] = []
        self._test_slot_versions: List[int] = []

    def add(self, episode: Episode):
        with self._lock:
            train = self._rng.random() > self.test_holdout
            buf = self._train if train else self._test
            versions = (self._train_slot_versions if train
                        else self._test_slot_versions)
            self.version += 1
            if len(buf) < self.capacity:
                buf.append(episode)
                versions.append(self.version)
            else:
                idx = int(self._rng.integers(0, self.capacity))
                buf[idx] = episode
                versions[idx] = self.version

    def __len__(self):
        with self._lock:
            return len(self._train)

    def size(self, training: bool = True):
        with self._lock:
            return len(self._train if training else self._test)

    def sample_episode(self, training: bool = True) -> Episode:
        with self._lock:
            buf = self._train if training else self._test
            return buf[self._rng.integers(0, len(buf))]


class HostActor:
    """Daemon thread playing episodes of a host env into a ReplayBuffer."""

    def __init__(
        self,
        make_env: Callable[[], object],
        buffer: ReplayBuffer,
        num_rewards: int,
        convert_frame: Callable = lambda s: s,
        policy: Optional[Callable] = None,
        max_trajectory_len: int = 150,
        max_episodes_per_env: int = 500,
        episode_sleep: float = 0.0,
        warmup_steps: int = 0,
        warmup_action: int = 0,
        split_reward: Optional[Callable] = None,
    ):
        self.make_env = make_env
        self.buffer = buffer
        self.num_rewards = num_rewards
        self.convert_frame = convert_frame
        self.policy = policy
        self.max_trajectory_len = max_trajectory_len
        self.max_episodes_per_env = max_episodes_per_env
        self.episode_sleep = episode_sleep
        # post-reset no-op steps (reference envs/sc2_micro_battle.py:39-41)
        self.warmup_steps = warmup_steps
        self.warmup_action = warmup_action
        # custom (reward_sum, info) -> reward-vector hook; zergling defense
        # takes its 4 channels from the info dict
        # (reference envs/sc2_zergling_defense.py:84).
        self.split_reward = split_reward
        self.episodes_played = 0
        self._thread: Optional[threading.Thread] = None
        self._env = None
        self.error: Optional[BaseException] = None
        self._stop = threading.Event()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout: float = 10.0):
        """Graceful shutdown: abandon the in-flight episode, join the
        thread, close the emulator.  (The reference leaks its daemon
        actors at exit, envs/minipacman.py:56.)"""
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
        env, self._env = self._env, None
        if env is not None:
            try:
                close = getattr(env, "close", None)
                if close:
                    close()
            except Exception:  # noqa: BLE001 - a torn-down emulator must not stop shutdown
                pass

    def play_episodes(self, n: int):
        """Synchronously play ``n`` episodes into the buffer, creating and
        recycling the env as needed (also the reference's on-demand refill
        path, envs/sc2_micro_battle.py:21-33)."""
        if self._env is None:
            self._env = self.make_env()
        for _ in range(n):
            self._play_episode(self._env)
            self.episodes_played += 1
            if (self.episodes_played % self.max_episodes_per_env) == 0:
                # recycle the env to flush emulator/game-process leaks
                try:
                    close = getattr(self._env, "close", None)
                    if close:
                        close()
                finally:
                    self._env = self.make_env()

    def _run(self):
        try:
            while not self._stop.is_set():
                self.play_episodes(1)
                if self.episode_sleep:
                    time.sleep(self.episode_sleep)
        except BaseException as e:  # surfaced to the trainer via liveness
            self.error = e
            # At interpreter shutdown the emulator's renderer/backends are
            # torn down under us; exit quietly instead of spamming
            # "Exception in thread".
            if sys.is_finalizing():
                return
            raise

    def _play_episode(self, env):
        states, rewards, actions = [], [], []
        state = env.reset()
        for _ in range(self.warmup_steps):
            state, _, warm_done, _ = env.step(self.warmup_action)
            if warm_done:
                # episode ended during warm-up: restart rather than step
                # (and record) a terminated env across a reset boundary
                state = env.reset()
        reward = np.zeros(self.num_rewards)
        done = False
        while True:
            if self._stop.is_set():
                return  # shutdown: drop the partial episode
            if self.policy is not None:
                action = self.policy(state)
            else:
                action = env.action_space.sample()
            states.append(np.asarray(self.convert_frame(state)))
            rewards.append(np.asarray(reward, np.float32).copy())
            actions.append(action)
            if len(states) >= self.max_trajectory_len:
                done = True
            if done:
                break
            state, reward_sum, done, info = env.step(action)
            reward = self._split_reward(reward_sum, info)
        self.buffer.add((np.array(states), np.array(rewards),
                         np.array(actions)))

    def _split_reward(self, reward_sum, info):
        """(positive, negative) channel split (envs/minipacman.py:104-106)
        when num_rewards == 2; raw scalar/vector otherwise."""
        if self.split_reward is not None:
            return np.atleast_1d(
                np.asarray(self.split_reward(reward_sum, info), np.float32))
        if self.num_rewards == 2 and np.isscalar(reward_sum):
            return np.array([max(0.0, reward_sum), min(0.0, reward_sum)],
                            np.float32)
        return np.atleast_1d(np.asarray(reward_sum, np.float32))


class _SlotArena:
    """Contiguous arenas feeding the C stitcher, one fixed-stride slot per
    buffer episode: episode i occupies rows [i*stride, i*stride+len_i).
    Slots are overwritten in place as episodes land or get reservoir-
    replaced, so steady-state ingest is O(changed episode); storage grows
    geometrically up to ``capacity`` slots."""

    def __init__(self, capacity: int, stride: int, frame_shape, reward_dim):
        self.capacity = capacity
        self.stride = stride
        self.slot_versions: List[int] = []
        # strong refs to the episodes last ingested per slot: keeps the
        # id()-based fallback versions stable (a replaced episode cannot be
        # freed and its address reused by a new one that would then alias
        # the cached slot version)
        self.slot_refs: List = []
        self.n_slots = 0
        self.frames = np.zeros((0,) + tuple(frame_shape), np.float32)
        self.rewards = np.zeros((0, reward_dim), np.float32)
        self.actions = np.zeros((0,), np.int32)
        self.lengths = np.zeros((0,), np.int32)

    def fits(self, episode) -> bool:
        frames = episode[0]
        return (len(frames) <= self.stride
                and tuple(np.asarray(frames).shape[1:])
                == self.frames.shape[1:])

    def _ensure(self, n_slots: int):
        if n_slots <= self.n_slots:
            return
        target = min(self.capacity, max(n_slots, 2 * self.n_slots))
        rows = target * self.stride
        for name in ("frames", "rewards", "actions"):
            old = getattr(self, name)
            grown = np.zeros((rows,) + old.shape[1:], old.dtype)
            grown[: old.shape[0]] = old
            setattr(self, name, grown)
        self.lengths = np.concatenate(
            [self.lengths, np.zeros(target - self.n_slots, np.int32)])
        self.n_slots = target

    def set_slot(self, i: int, episode):
        frames, rewards, actions = episode
        self._ensure(i + 1)
        n = len(frames)
        row = i * self.stride
        self.frames[row:row + n] = np.asarray(frames, np.float32)
        r = np.asarray(rewards, np.float32)
        if r.ndim == 1:
            r = r[:, None]
        self.rewards[row:row + n] = r
        self.actions[row:row + n] = np.asarray(actions).reshape(-1)
        self.lengths[i] = n


def to_device_batch(states, rewards, dones, actions, device):
    """Stitched numpy clips -> (obs NHWC f32, rewards f32, dones bool,
    actions int64) on ``device``.  The clips stay channels-first on the host;
    the copy moves them as stitched and the card moves the channel axis
    last (on the CPU the move is a host copy)."""
    obs = torch.from_numpy(states).to(device).movedim(2, -1).contiguous()
    return (obs, torch.from_numpy(rewards).to(device),
            torch.from_numpy(dones).to(device),
            torch.from_numpy(actions.astype(np.int64)).to(device))


class HostReplayDatasource:
    """Datasource facade over HostActors + a ReplayBuffer, exposing the
    reference's ``get_trajectories`` contract for host-process envs and the
    port's ``collect`` on ``device``."""

    def __init__(self, make_env, num_actions: int, num_rewards: int,
                 channels: int, convert_frame=lambda s: s,
                 min_buffer_len: int = 4, capacity: int = 50,
                 max_trajectory_len: int = 150, seed: int = 0,
                 policy=None, warmup_steps: int = 0, warmup_action: int = 0,
                 split_reward=None, sync_refill_factor: Optional[int] = None,
                 name: str = "host", height: int = 64, width: int = 64,
                 n_actors: int = 1, device="cuda"):
        self.binary_input_channels = num_actions
        self.scalar_output_channels = num_rewards
        self.conv_input_channels = channels
        self.conv_output_channels = channels
        self.name = name
        self.height = height
        self.width = width
        self.min_buffer_len = min_buffer_len
        self.device = resolve_device(device)
        self._make_env = make_env
        self._convert = convert_frame
        # sync_refill_factor = the reference's REPLAY_FACTOR pattern
        # (envs/sc2_micro_battle.py:10,72-74): no daemon thread; every
        # get_trajectories synchronously plays
        # max(batch - len(buffer), ceil(batch / factor)) fresh episodes.
        self.sync_refill_factor = sync_refill_factor
        self.buffer = ReplayBuffer(capacity=capacity, seed=seed)
        # N daemon actors, one shared (locked) buffer: each actor owns its
        # own emulator and plays whole episodes concurrently into the same
        # buffer, so ingest scales with actor count (the reference steps a
        # batch of slow host envs in a 4-worker pool, multi_env.py:8-39).
        if n_actors < 1:
            raise ValueError(f"n_actors must be >= 1, got {n_actors}")
        self.actors = [
            HostActor(make_env, self.buffer, num_rewards,
                      convert_frame, policy=policy,
                      max_trajectory_len=max_trajectory_len,
                      warmup_steps=warmup_steps,
                      warmup_action=warmup_action,
                      split_reward=split_reward)
            for _ in range(n_actors)
        ]
        self.actor = self.actors[0]  # sync-refill handle
        self._started = False
        self._rng = np.random.default_rng(seed)
        # per-split (training bool -> _SlotArena) stitch cache
        self._arena_cache: dict = {}

    @property
    def spec(self):
        """EnvSpec view for model sizing (``init_train_state`` reads
        num_actions/num_rewards/channels/height).  The dynamics live in the
        host process, not on the device."""
        from scmgan_tpu_torch.envs.base import EnvSpec

        return EnvSpec(
            name=self.name,
            num_actions=self.binary_input_channels,
            num_rewards=self.scalar_output_channels,
            channels=self.conv_input_channels,
            height=self.height,
            width=self.width,
            reset=None, draw_noise=None, step=None, render=None,
        )

    def _ensure_started(self):
        if not self._started:
            for a in self.actors:
                a.start()
            self._started = True
        dead = [a for a in self.actors if not a.is_alive()]
        if dead:
            # one crashed actor is fatal, like the reference's single-actor
            # liveness check (envs/minipacman.py:126-128): a silent degrade
            # would skew the data toward the surviving actors' seeds
            raise RuntimeError(
                f"Simulator thread crashed "
                f"({len(dead)}/{len(self.actors)} actors): "
                f"{dead[0].error!r}")

    def close(self):
        """Stop the background actors and close their emulators
        (idempotent)."""
        if self._started:
            for a in self.actors:
                a.stop()
            self._started = False

    def make_env(self, *args, **kwargs):
        return self._make_env(*args, **kwargs)

    def convert_frame(self, state):
        s = self._convert(state)
        return s, s

    def _fill(self, batch_size: int, training: bool):
        """Refill (synchronous mode) or start the actors, then wait until
        the split holds ``min_buffer_len`` episodes."""
        if self.sync_refill_factor is not None:
            # on-demand refill instead of a daemon actor
            # (envs/sc2_micro_battle.py:70-74)
            need = max(batch_size - self.buffer.size(training),
                       math.ceil(batch_size / self.sync_refill_factor))
            self.actor.play_episodes(need)
        else:
            self._ensure_started()
        while self.buffer.size(training) < self.min_buffer_len:
            if self.sync_refill_factor is not None:
                self.actor.play_episodes(1)
                continue
            print("Waiting for replay buffer to fill, buffer size {}/{}..."
                  .format(self.buffer.size(training), self.min_buffer_len))
            time.sleep(1)
            self._ensure_started()

    def get_trajectories(self, batch_size: int = 8, timesteps: int = 10,
                         random_start: bool = True, training: bool = True,
                         policy: str = "random"):
        """Sample + stitch clips to exactly ``timesteps`` steps
        (envs/minipacman.py:139-164) with the native C stitcher
        (``native/src/stitcher.c``).  Returns numpy states (B, T, C, H, W),
        rewards (B, T, R), dones (B, T) bool and actions (B, T) int32."""
        self._fill(batch_size, training)
        return self._native_stitch(batch_size, timesteps, random_start, training)

    def get_trajectories_plain(self, batch_size: int = 8, timesteps: int = 10,
                               random_start: bool = True, training: bool = True):
        """The JAX module's Python stitch loop (replay.py:409-433): the plain
        version of the native stitcher, drawing episodes from the buffer's
        generator and starts from the datasource's."""
        self._fill(batch_size, training)
        states_b, rewards_b, dones_b, actions_b = [], [], [], []
        for _ in range(batch_size):
            states, rewards, actions, dones = [], [], [], []
            remaining = timesteps
            while remaining > 0:
                ep_s, ep_r, ep_a = self.buffer.sample_episode(training)
                if random_start and len(ep_s) > 4:
                    start = self._rng.integers(0, len(ep_s) - 3)
                else:
                    start = 0
                end = min(start + remaining, len(ep_s) - 1)
                duration = end - start
                if duration <= 0:
                    continue
                states.extend(ep_s[start:end])
                rewards.extend(ep_r[start:end])
                actions.extend(ep_a[start:end])
                dones.extend([False] * (duration - 1) + [True])
                remaining -= duration
            states_b.append(np.array(states))
            rewards_b.append(np.array(rewards))
            dones_b.append(np.array(dones))
            actions_b.append(np.array(actions))
        return (np.array(states_b), np.array(rewards_b),
                np.array(dones_b), np.array(actions_b))

    def _native_stitch(self, batch_size, timesteps, random_start, training):
        """Assemble the batch with the C stitcher over slotted arenas.

        The arena is incremental, keyed on the buffer's per-slot versions:
        only episodes that changed since the last call are copied in
        (O(episode) per new episode); a whole-arena rebuild per call would
        be O(buffer), hundreds of MB per train iteration on a live env."""
        from scmgan_tpu_torch.native import stitch_batch

        buf_obj = self.buffer
        with buf_obj._lock:
            buf = buf_obj._train if training else buf_obj._test
            versions = list(buf_obj._train_slot_versions if training
                            else buf_obj._test_slot_versions)
            all_eps = list(buf)  # refs only; episodes are write-once
            if len(versions) != len(all_eps):
                # buffer was filled out-of-band (hand-built in tests),
                # bypassing add()'s version tracking: key slots on episode
                # identity instead (negative: disjoint from real versions)
                versions = [-id(ep) for ep in all_eps]
        if not all_eps:
            raise ValueError("the replay split holds no episode to stitch")
        arena = self._arena_cache.get(training)
        if arena is None:
            changed = list(enumerate(all_eps))
        else:
            changed = [(i, ep) for i, ep in enumerate(all_eps)
                       if (i >= len(arena.slot_versions)
                           or arena.slot_versions[i] != versions[i])]
        if changed and (arena is None
                        or not all(arena.fits(ep) for _, ep in changed)):
            # (re)build: stride must fit every episode in the buffer
            changed = list(enumerate(all_eps))
            stride = max([len(ep[0]) for ep in all_eps]
                         + [self.actor.max_trajectory_len])
            r0 = np.asarray(all_eps[0][1], np.float32)
            arena = _SlotArena(
                capacity=buf_obj.capacity, stride=stride,
                frame_shape=np.asarray(all_eps[0][0]).shape[1:],
                reward_dim=1 if r0.ndim == 1 else r0.shape[1])
        for i, ep in changed:
            arena.set_slot(i, ep)
        arena.slot_versions = versions
        arena.slot_refs = all_eps
        self._arena_cache[training] = arena
        n = len(versions)
        offsets = np.arange(n, dtype=np.int64) * arena.stride
        seed = int(self._rng.integers(1, 2 ** 62))
        return stitch_batch(arena.frames, arena.rewards, arena.actions,
                            offsets, arena.lengths[:n],
                            batch_size, timesteps,
                            random_start=random_start, seed=seed)

    def collect(self, batch_size: int, timesteps: int,
                generator: Optional[torch.Generator] = None,
                training: bool = True, policy: str = "random"):
        """(obs NHWC f32, rewards (B,T,R) f32, dones (B,T) bool, actions
        (B,T) int64) on the datasource's device.

        Stored episodes follow the reference's channels-first convention
        (convert_frame transposes to CHW, envs/minipacman.py:167-168); the
        trainer consumes NHWC, so the channel axis moves last after the
        copy (``to_device_batch``).  ``training=False`` samples the 20% test
        holdout (reference main.py:791, envs/minipacman.py:112-119).
        ``generator`` (optional) reseeds the clip-sampling stream from one
        non-negative int64 draw, so a caller's generator decides the
        clips; ``policy`` is the actors', fixed at construction."""
        if generator is not None:
            seed = torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                                 device=generator.device)
            self._rng = np.random.default_rng(int(seed))
        return to_device_batch(*self.get_trajectories(
            batch_size, timesteps, training=training), self.device)
