"""The port's replay buffer and host actor (scmgan_tpu_torch.data.replay)
against scmgan_tpu.data.replay on the CPU.

Each case of the JAX package's tests/test_replay.py runs against both
packages (``pkg``), with a fake in-process environment; then the two
packages' stitching is held bit-equal on the same hand-filled buffers and
seed, through the native stitcher and the plain Python loop, and the port's
``collect`` equal to JAX's with no key.  Every test that starts an actor
stops it in a ``finally`` block: a leaked daemon actor keeps allocating for
the rest of the session.
"""

import functools
import time
import types

import jax
import numpy as np
import pytest
import torch

from scmgan_tpu.data import replay as jreplay
from scmgan_tpu.envs.host import multi_env as jmulti
from scmgan_tpu_torch.data import replay as treplay
from scmgan_tpu_torch.envs.host import multi_env as tmulti
from test_torch_port_native import ensure_jax_native

PACKAGES = {
    "jax": types.SimpleNamespace(
        name="jax", ReplayBuffer=jreplay.ReplayBuffer, HostActor=jreplay.HostActor,
        HostReplayDatasource=jreplay.HostReplayDatasource,
        MultiHostEnvironment=jmulti.MultiHostEnvironment,
        native_stitch=lambda ds, *a: ds._try_native_stitch(*a)),
    "port": types.SimpleNamespace(
        name="port", ReplayBuffer=treplay.ReplayBuffer, HostActor=treplay.HostActor,
        HostReplayDatasource=functools.partial(treplay.HostReplayDatasource,
                                               device="cpu"),
        MultiHostEnvironment=tmulti.MultiHostEnvironment,
        native_stitch=lambda ds, *a: ds._native_stitch(*a)),
}


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


class FakeEnv:
    """Tiny deterministic episode generator standing in for ALE/SC2."""

    class _Space:
        def __init__(self, n):
            self.n = n

        def sample(self):
            return np.random.randint(self.n)

    def __init__(self, episode_len=6):
        self.action_space = self._Space(3)
        self.episode_len = episode_len
        self.t = 0
        self.closed = False

    def reset(self):
        self.t = 0
        # CHW frames, the storage convention (reference convert_frame
        # transposes to channels-first, envs/minipacman.py:167-168)
        return np.full((2, 4, 4), self.t, np.float32)

    def step(self, action):
        self.t += 1
        done = self.t >= self.episode_len
        obs = np.full((2, 4, 4), self.t, np.float32)
        return obs, float(action), done, {}

    def close(self):
        self.closed = True


class CrashingEnv(FakeEnv):
    def reset(self):
        raise RuntimeError("emulator exploded")


def test_replay_buffer_split_and_reservoir(pkg):
    buf = pkg.ReplayBuffer(capacity=5, test_holdout=0.5, seed=0)
    for i in range(40):
        buf.add((np.full(3, i), np.zeros(3), np.zeros(3)))
    assert buf.size(True) <= 5 and buf.size(False) <= 5
    assert buf.size(True) + buf.size(False) == 10
    ep = buf.sample_episode(True)
    assert len(ep) == 3


def test_replay_buffer_same_draws_as_jax():
    """The same adds give the same splits, slots, versions and samples."""
    bufs = [p.ReplayBuffer(capacity=4, test_holdout=0.3, seed=9)
            for p in (PACKAGES["jax"], PACKAGES["port"])]
    for buf in bufs:
        for i in range(25):
            buf.add((np.full(2, i), np.zeros(2), np.zeros(2)))
    j, t = bufs
    for split in ("_train", "_test"):
        assert [int(e[0][0]) for e in getattr(t, split)] == [
            int(e[0][0]) for e in getattr(j, split)]
    assert t._train_slot_versions == j._train_slot_versions
    assert t._test_slot_versions == j._test_slot_versions
    assert t.version == j.version == 25
    assert [int(t.sample_episode(True)[0][0]) for _ in range(10)] == [
        int(j.sample_episode(True)[0][0]) for _ in range(10)]


def test_host_actor_fills_buffer(pkg):
    buf = pkg.ReplayBuffer(capacity=10, test_holdout=0.0, seed=0)
    actor = pkg.HostActor(FakeEnv, buf, num_rewards=2, max_trajectory_len=8)
    actor.start()
    try:
        deadline = time.time() + 10
        while len(buf) < 2 and time.time() < deadline:
            time.sleep(0.05)
        assert len(buf) >= 2
        assert actor.is_alive()
        states, rewards, actions = buf.sample_episode(True)
        assert states.shape[1:] == (2, 4, 4)
        assert rewards.shape[1] == 2  # pos/neg split for scalar rewards
        # the first recorded reward is the pre-step zero (reference
        # envs/minipacman.py:95-108 records reward lagged by one step)
        np.testing.assert_array_equal(rewards[0], [0.0, 0.0])
    finally:
        actor.stop()
    assert not actor.is_alive()


def test_host_replay_datasource_contract(pkg):
    ds = pkg.HostReplayDatasource(
        FakeEnv, num_actions=3, num_rewards=2, channels=2,
        min_buffer_len=2, max_trajectory_len=8, seed=0)
    try:
        states, rewards, dones, actions = ds.get_trajectories(
            batch_size=3, timesteps=10)
        assert states.shape[0] == 3 and states.shape[1] == 10
        assert rewards.shape == (3, 10, 2)
        assert dones.shape == (3, 10)
        # clip joins carry synthetic dones (episodes are 8 steps < 10)
        assert dones.any(axis=1).all()
        obs, rew, dn, act = ds.collect(2, 6)
        assert obs.shape[0] == 2 and obs.shape[1] == 6
        assert obs.shape[-1] == 2  # NHWC channels last
        spec = ds.spec
        assert (spec.num_actions, spec.num_rewards, spec.channels) == (3, 2, 2)
        assert spec.step is None and spec.reset is None
    finally:
        ds.close()


def test_actor_death_detected(pkg):
    ds = pkg.HostReplayDatasource(
        CrashingEnv, num_actions=3, num_rewards=1, channels=2,
        min_buffer_len=1, seed=0)
    try:
        with pytest.raises(RuntimeError, match="Simulator thread crashed"):
            deadline = time.time() + 10
            while time.time() < deadline:
                ds.get_trajectories(1, 4)
                time.sleep(0.1)
    finally:
        ds.close()


def _episode(value, n=8):
    return (np.full((n, 2, 4, 4), value, np.float32),
            np.zeros((n, 2), np.float32),
            np.zeros((n,), np.int64))


def test_collect_training_flag_selects_split(pkg):
    """use_training_set must reach the buffer split: train episodes are
    all-1.0 frames, test episodes all-2.0."""
    ds = pkg.HostReplayDatasource(
        FakeEnv, num_actions=3, num_rewards=2, channels=2,
        min_buffer_len=1, max_trajectory_len=8, seed=0)
    ds._ensure_started = lambda: None  # no actor: buffers are hand-filled
    for _ in range(3):
        ds.buffer._train.append(_episode(1.0))
        ds.buffer._test.append(_episode(2.0))
    obs_tr, _, _, _ = ds.collect(2, 5, training=True)
    obs_te, _, _, _ = ds.collect(2, 5, training=False)
    assert float(np.asarray(obs_tr).min()) == float(np.asarray(obs_tr).max()) == 1.0
    assert float(np.asarray(obs_te).min()) == float(np.asarray(obs_te).max()) == 2.0


def test_native_stitch_arena_incremental(pkg):
    """The stitch arena is slotted and incremental: unchanged calls do no
    copy work, and a new episode only touches its own slot."""
    ds = pkg.HostReplayDatasource(
        FakeEnv, num_actions=3, num_rewards=2, channels=2, seed=0)
    ds.buffer.test_holdout = -1.0  # deterministic: every episode -> train
    ep = (np.zeros((8, 2, 4, 4), np.float32),
          np.zeros((8, 2), np.float32), np.zeros((8,), np.int64))
    for _ in range(5):
        ds.buffer.add(ep)
    assert pkg.native_stitch(ds, 2, 6, True, True) is not None
    arena = ds._arena_cache[True]
    frames0 = arena.frames
    pkg.native_stitch(ds, 2, 6, True, True)
    assert ds._arena_cache[True] is arena  # cache hit: same arena object
    assert arena.frames is frames0

    ep2 = (np.full((6, 2, 4, 4), 0.5, np.float32),
           np.ones((6, 2), np.float32), np.ones((6,), np.int64))
    ds.buffer.add(ep2)  # appends slot 5; slots 0-4 untouched
    pkg.native_stitch(ds, 2, 6, True, True)
    arena2 = ds._arena_cache[True]
    assert arena2 is arena  # updated in place, not rebuilt
    assert arena2.slot_versions == ds.buffer._train_slot_versions
    for i, e in enumerate(ds.buffer._train):
        row = i * arena2.stride
        assert arena2.lengths[i] == len(e[0])
        np.testing.assert_array_equal(arena2.frames[row], np.asarray(e[0][0], np.float32))

    # reservoir replacement: overwrite a slot, only that slot re-ingests
    ds.buffer.capacity = len(ds.buffer._train)
    ep3 = (np.full((7, 2, 4, 4), 0.25, np.float32),
           np.zeros((7, 2), np.float32), np.zeros((7,), np.int64))
    ds.buffer.add(ep3)
    pkg.native_stitch(ds, 2, 6, True, True)
    arena3 = ds._arena_cache[True]
    assert arena3 is arena
    assert arena3.slot_versions == ds.buffer._train_slot_versions
    replaced = [i for i, e in enumerate(ds.buffer._train) if len(e[0]) == 7]
    assert len(replaced) == 1
    row = replaced[0] * arena3.stride
    np.testing.assert_array_equal(arena3.frames[row:row + 7],
                                  np.full((7, 2, 4, 4), 0.25, np.float32))


def _frozen(pkg, n_eps=6):
    ds = pkg.HostReplayDatasource(
        FakeEnv, num_actions=3, num_rewards=2, channels=2, seed=0)
    ds.buffer.test_holdout = -1.0
    # freeze the buffer: no actor thread races episodes into the reservoir
    ds._ensure_started = lambda: None
    for i in range(n_eps):
        frames = np.arange(10, dtype=np.float32).reshape(10, 1, 1, 1)
        frames = np.broadcast_to(frames + 100 * i, (10, 2, 4, 4)).copy()
        ds.buffer.add((frames, np.zeros((10, 2), np.float32),
                       np.zeros((10,), np.int64)))
    return ds


def test_collect_key_drives_clip_sampling(pkg):
    """collect's key (JAX) or generator (port) reseeds the clip-sampling
    stream: the same key reproduces the batch, another draws other clips."""
    if pkg.name == "jax":
        k0, k1 = jax.random.PRNGKey(7), jax.random.PRNGKey(8)
        kw = lambda k: {"key": k}  # noqa: E731
    else:
        k0, k1 = 7, 8
        kw = lambda k: {"generator": torch.Generator().manual_seed(k)}  # noqa: E731
    b_a = np.asarray(_frozen(pkg).collect(4, 5, **kw(k0))[0])
    b_same = np.asarray(_frozen(pkg).collect(4, 5, **kw(k0))[0])
    b_diff = np.asarray(_frozen(pkg).collect(4, 5, **kw(k1))[0])
    np.testing.assert_array_equal(b_a, b_same)
    assert not np.array_equal(b_a, b_diff)


def test_collect_generator_seeding_rule():
    """The port reseeds from one non-negative int64 draw of the generator."""
    g = torch.Generator().manual_seed(11)
    seed = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=torch.Generator().manual_seed(11)))
    got = _frozen(PACKAGES["port"]).collect(4, 5, generator=g)
    ref = _frozen(PACKAGES["port"])
    ref._rng = np.random.default_rng(seed)
    want = treplay.to_device_batch(*ref.get_trajectories(4, 5), "cpu")
    for w, x in zip(want, got):
        assert torch.equal(w, x)


def test_warmup_resets_on_early_termination(pkg):
    """Warm-up no-ops must not step (and then record) a terminated env
    across a reset boundary; the episode restarts instead."""
    buf = pkg.ReplayBuffer(capacity=4, test_holdout=-1.0, seed=0)
    actor = pkg.HostActor(lambda: FakeEnv(episode_len=2), buf, num_rewards=1,
                          warmup_steps=3, max_trajectory_len=5)
    actor.play_episodes(1)
    frames, _, _ = buf._train[0]
    # warm-up hits done at t=2, resets, takes one more warm-up step ->
    # recording starts at t=1
    assert frames[0].max() == 1.0


def test_actor_stop_joins_and_closes(pkg):
    """close()/stop() joins the daemon thread and closes the emulator."""
    ds = pkg.HostReplayDatasource(
        lambda: FakeEnv(episode_len=1000), num_actions=3, num_rewards=1,
        channels=2, min_buffer_len=1, max_trajectory_len=1000, seed=0)
    ds.buffer.test_holdout = -1.0
    try:
        ds._ensure_started()
        time.sleep(0.2)  # let it get mid-episode
        env = ds.actor._env
    finally:
        ds.close()
    assert not ds.actor.is_alive()
    assert env is not None and env.closed
    ds.close()  # idempotent


def test_n_actors_fill_one_buffer_and_scale_ingest(pkg):
    """N daemon actors, one buffer: with a slow env (a sleep inside step),
    4 actors ingest episodes materially faster than 1."""

    class SlowEnv(FakeEnv):
        def step(self, action):
            time.sleep(0.01)  # releases the GIL, like a real emulator
            return super().step(action)

    def ingest_rate(n_actors):
        ds = pkg.HostReplayDatasource(
            SlowEnv, num_actions=3, num_rewards=1, channels=2,
            min_buffer_len=1, max_trajectory_len=6, seed=0, n_actors=n_actors)
        ds.buffer.test_holdout = -1.0
        try:
            ds._ensure_started()
            time.sleep(1.0)
            return ds.buffer.version  # == episodes ingested
        finally:
            ds.close()

    r1, r4 = ingest_rate(1), ingest_rate(4)
    assert r4 >= 2 * r1, (r1, r4)
    ds = pkg.HostReplayDatasource(
        SlowEnv, num_actions=3, num_rewards=1, channels=2,
        min_buffer_len=1, n_actors=3, seed=0)
    try:
        ds._ensure_started()
    finally:
        ds.close()
    assert not any(a.is_alive() for a in ds.actors)
    with pytest.raises(ValueError, match="n_actors"):
        pkg.HostReplayDatasource(FakeEnv, num_actions=3, num_rewards=1, channels=2,
                                 n_actors=0)


def test_n_actors_any_death_detected(pkg):
    calls = [0]

    def make_env():
        calls[0] += 1
        return FakeEnv() if calls[0] % 2 else CrashingEnv()

    ds = pkg.HostReplayDatasource(
        make_env, num_actions=3, num_rewards=1, channels=2,
        min_buffer_len=1, n_actors=2, seed=0)
    try:
        with pytest.raises(RuntimeError, match="Simulator thread crashed"):
            deadline = time.time() + 10
            while time.time() < deadline:
                ds.get_trajectories(1, 4)
                time.sleep(0.1)
    finally:
        ds.close()


def test_multi_host_environment_contract(pkg):
    """Thread-pooled synchronous batch stepping (reference
    multi_env.py:14-38): stacked outputs, auto-reset of finished envs."""
    envs = [FakeEnv(episode_len=2 + i) for i in range(4)]
    menv = pkg.MultiHostEnvironment(envs)
    try:
        states0 = menv.reset()
        assert len(states0) == 4
        assert menv.action_space.n == 3
        s, r, d, infos = menv.step([1, 1, 1, 1])
        assert s.shape == (4, 2, 4, 4)
        assert r.shape == (4,) and d.shape == (4,)
        assert len(infos) == 4
        s, r, d, _ = menv.step([2, 2, 2, 2])
        assert bool(d[0]) and not bool(d[3])
        assert envs[0].t == 0  # auto-reset happened
        s, r, d, _ = menv.step([0, 0, 0, 0])
        assert not bool(d[0])  # fresh episode running
        with pytest.raises(ValueError):
            menv.step([0, 0])
    finally:
        menv.close()
    assert all(e.closed for e in envs)
    with pytest.raises(ValueError, match="at least one env"):
        pkg.MultiHostEnvironment([])


# ---------------------------------------------------------------------------
# the two packages on the same buffers
# ---------------------------------------------------------------------------

def _hand_filled(pkg, seed=3, lengths=(12, 7, 30, 5, 2, 19), test_lengths=(9, 14)):
    """A datasource whose buffers hold the same seeded episodes in both
    packages, filled out of band (no versions: the arena keys on ids)."""
    rng = np.random.default_rng(seed)
    ds = pkg.HostReplayDatasource(FakeEnv, num_actions=4, num_rewards=2, channels=3,
                                  min_buffer_len=1, max_trajectory_len=30, seed=seed)
    ds._ensure_started = lambda: None
    for split, ls in ((ds.buffer._train, lengths), (ds.buffer._test, test_lengths)):
        for n in ls:
            split.append((rng.random((n, 3, 5, 6)).astype(np.float32),
                          rng.integers(-1, 2, (n, 2)).astype(np.float32),
                          rng.integers(0, 4, n)))
    return ds


@pytest.mark.parametrize("training", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("random_start", [True, False], ids=["random_start", "start0"])
def test_get_trajectories_bit_equal_to_jax(training, random_start):
    """The native stitcher: the same buffers and ``_rng`` seed give the same
    batches in both packages, call after call."""
    jds, tds = _hand_filled(PACKAGES["jax"]), _hand_filled(PACKAGES["port"])
    for b, t in ((4, 10), (3, 25), (5, 1)):
        want = jds.get_trajectories(b, t, random_start=random_start, training=training)
        got = tds.get_trajectories(b, t, random_start=random_start, training=training)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("random_start", [True, False], ids=["random_start", "start0"])
def test_plain_stitch_loop_bit_equal_to_jax(monkeypatch, random_start):
    """The plain version: JAX's Python loop (reached when its native module
    is missing) against the port's ``get_trajectories_plain``."""
    jds, tds = _hand_filled(PACKAGES["jax"]), _hand_filled(PACKAGES["port"])
    monkeypatch.setattr(jds, "_try_native_stitch", lambda *a: None)
    for b, t in ((4, 10), (2, 33)):
        want = jds.get_trajectories(b, t, random_start=random_start)
        got = tds.get_trajectories_plain(b, t, random_start=random_start)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
            assert g.shape == w.shape


def test_stitched_clips_are_contiguous_with_done_at_joins():
    """Every stitched clip is a run of consecutive steps of one stored
    episode, ending before its last step, and ``done`` marks exactly its
    end (a join or the row's end)."""
    ds = _hand_filled(PACKAGES["port"])
    frames, rewards, dones, actions = ds.get_trajectories(6, 40)
    eps = ds.buffer._train
    for b in range(6):
        t = 0
        for end in np.flatnonzero(dones[b]):
            clip = frames[b, t:end + 1]
            hits = [(e, s) for e, ep in enumerate(eps)
                    for s in range(len(ep[0]) - len(clip))
                    if np.array_equal(ep[0][s:s + len(clip)], clip)]
            assert hits, (b, t, end)
            e, s = hits[0]
            np.testing.assert_array_equal(rewards[b, t:end + 1], eps[e][1][s:s + len(clip)])
            np.testing.assert_array_equal(actions[b, t:end + 1], eps[e][2][s:s + len(clip)])
            t = end + 1
        assert t == 40


def test_collect_equals_jax_collect_without_key():
    jds, tds = _hand_filled(PACKAGES["jax"]), _hand_filled(PACKAGES["port"])
    for training in (True, False, True):
        want = jds.collect(3, 8, training=training)
        got = tds.collect(3, 8, training=training)
        assert got[0].dtype == torch.float32 and got[0].shape == (3, 8, 5, 6, 3)
        assert got[2].dtype == torch.bool and got[3].dtype == torch.int64
        assert got[0].is_contiguous()
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stitcher_that_cannot_build_raises(monkeypatch):
    """No fall-back to the Python loop: the stitcher's build error surfaces."""
    import scmgan_tpu_torch.native as tnative

    def broken(*a, **k):
        raise RuntimeError("cc failed with code 1:\nno compiler")

    monkeypatch.setattr(tnative, "stitch_batch", broken)
    ds = _hand_filled(PACKAGES["port"])
    with pytest.raises(RuntimeError, match="cc failed"):
        ds.get_trajectories(2, 5)
    with pytest.raises(RuntimeError, match="cc failed"):
        ds.collect(2, 5)


def test_datasource_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treplay.HostReplayDatasource(FakeEnv, num_actions=3, num_rewards=1, channels=2)
