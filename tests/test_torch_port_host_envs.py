"""The port's host env adapters (scmgan_tpu_torch.envs.host) against
scmgan_tpu.envs.host on the CPU.

The preprocessing functions and both policies are exact on seeded numpy
inputs; the SC2, Atari, Centipede and gym pipelines run on fake backends and
fill the same buffers as JAX's; allocation of every host name raises the
same exception type as JAX's where a backend is absent; and where
``gymnasium`` imports, the live gym contract and one train step on
CarRacing frames.  Every datasource whose actor starts is closed in a
``finally`` block (or a fixture's teardown).
"""

import importlib
import sys
import types

import numpy as np
import pytest
import torch

from scmgan_tpu.data import datasource as jdatasource
from scmgan_tpu.data import replay as jreplay
from scmgan_tpu.envs.host import atari as jatari
from scmgan_tpu.envs.host import centipede as jcent
from scmgan_tpu.envs.host import fourtowers as jtowers
from scmgan_tpu.envs.host import gym_compat as jcompat
from scmgan_tpu.envs.host import gym_make as jmake
from scmgan_tpu.envs.host import gym_pixel as jpixel
from scmgan_tpu.envs.host import sc2 as jsc2
from scmgan_tpu_torch.data import datasource as tdatasource
from scmgan_tpu_torch.data import replay as treplay
from scmgan_tpu_torch.envs.host import atari as tatari
from scmgan_tpu_torch.envs.host import centipede as tcent
from scmgan_tpu_torch.envs.host import fourtowers as ttowers
from scmgan_tpu_torch.envs.host import gym_compat as tcompat
from scmgan_tpu_torch.envs.host import gym_make as tmake
from scmgan_tpu_torch.envs.host import gym_pixel as tpixel
from scmgan_tpu_torch.envs.host import sc2 as tsc2
from test_torch_port_native import ensure_jax_native


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _same_buffers(tds, jds):
    for split in ("_train", "_test"):
        t, j = getattr(tds.buffer, split), getattr(jds.buffer, split)
        assert len(t) == len(j)
        for te, je in zip(t, j):
            for a, b in zip(te, je):
                _same(a, b)


# ---------------------------------------------------------------------------
# preprocessing and policies, exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,block", [((16, 12), 2), ((17, 13), 4), ((9, 30), 3)])
def test_block_reduce_max_exact(shape, block):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    _same(tatari.block_reduce_max(x, block), jatari.block_reduce_max(x, block))


@pytest.mark.parametrize("fn", ["convert_pong", "convert_breakout"])
def test_atari_frame_conversions_exact(fn):
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (3, 210, 160, 3)).astype(np.uint8)
    frames[1] = 144            # a flat frame: binarized to all zeros after the min
    _same(getattr(tatari, fn)(frames), getattr(jatari, fn)(frames))


@pytest.mark.parametrize("shape", [(210, 160, 3), (96, 96, 3), (50, 70, 3), (64, 64, 3)])
def test_crop_resize_64_exact(shape):
    rgb = np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8)
    out = tatari.crop_resize_64(rgb)
    assert out.shape == (3, 64, 64)
    _same(out, jatari.crop_resize_64(rgb))


def test_centipede_crop_exact():
    rgb = np.random.default_rng(3).integers(0, 256, (210, 160, 3)).astype(np.uint8)
    _same(tcent.CentipedeEnv._crop(rgb), jcent.CentipedeEnv._crop(rgb))


def test_sc2_frame_conversions_exact():
    rng = np.random.default_rng(4)
    feats = rng.random((4, 8, 8))
    rgb = rng.integers(0, 256, (16, 20, 3)).astype(np.uint8)
    for state in ((feats, rgb), feats):
        _same(tsc2.convert_frame(state), jsc2.convert_frame(state))
    zstate = (np.zeros((4, 8, 8)), feats, np.zeros((8, 8, 3)), rgb)
    for state in (zstate, feats):
        _same(tsc2.zergling_convert_frame(state), jsc2.zergling_convert_frame(state))
    for state in ((None, None, None, rgb), [None, None, None, rgb], rgb):
        _same(tsc2.micro_battle_convert_frame(state), jsc2.micro_battle_convert_frame(state))
    info = {"a": 1.0, "b": -2.0, "c": 3.5, "d": 0.0}
    _same(tsc2.zergling_split_reward(0.0, info), jsc2.zergling_split_reward(0.0, info))
    for mod in (tsc2, jsc2):
        with pytest.raises(ValueError, match="reward vector"):
            mod.zergling_split_reward(0.0, {**info, "extra": 1.0})


@pytest.mark.parametrize("seed", [0, 5])
def test_policies_match_jax_draw_for_draw(seed):
    t, j = tcent.HeuristicPolicy(seed=seed), jcent.HeuristicPolicy(seed=seed)
    assert [t() for _ in range(500)] == [j() for _ in range(500)]
    t = tsc2.NoopBiasedPolicy(5, tsc2.ZERGLING_NOOP_ACTION, seed=seed)
    j = jsc2.NoopBiasedPolicy(5, jsc2.ZERGLING_NOOP_ACTION, seed=seed)
    acts = [t(None) for _ in range(2000)]
    assert acts == [j(None) for _ in range(2000)]
    noop = np.mean(np.array(acts) == tsc2.ZERGLING_NOOP_ACTION)
    assert 0.88 <= noop <= 0.96 and len(set(acts)) > 1


def test_sc2_tables_match_jax():
    assert tsc2.SC2_GAMES == jsc2.SC2_GAMES
    assert tsc2._VARIANT_MAPS == jsc2._VARIANT_MAPS
    for name in ("SCREEN_SIZE", "ZERGLING_NOOP_ACTION", "ZERGLING_NOOP_PROB",
                 "ZERGLING_MAX_TRAJECTORY", "ZERGLING_NUM_REWARDS",
                 "MICRO_BATTLE_REPLAY_FACTOR", "MICRO_BATTLE_BUFFER_LEN",
                 "MICRO_BATTLE_MAX_TRAJECTORY", "MICRO_BATTLE_WARMUP_STEPS"):
        assert getattr(tsc2, name) == getattr(jsc2, name), name


# ---------------------------------------------------------------------------
# SC2 pipelines on fake envs
# ---------------------------------------------------------------------------

class _Space:
    def __init__(self, n):
        self.n = n

    def sample(self):
        return np.random.randint(self.n)


class FakeZerglingEnv:
    """4-tuple states, 4-channel info-dict rewards, 5 actions
    (reference envs/sc2_zergling_defense.py)."""

    def __init__(self, episode_len=6):
        self.action_space = _Space(5)
        self.episode_len = episode_len
        self.t = 0

    def _state(self):
        return (np.zeros((4, 8, 8)), np.full((4, 8, 8), self.t, np.float32),
                np.zeros((8, 8, 3)), np.full((8, 8, 3), 7, np.uint8))

    def reset(self):
        self.t = 0
        return self._state()

    def step(self, action):
        self.t += 1
        info = {"damage_taken": 1.0 * action, "damage_dealt": 2.0,
                "kills": 3.0, "score": 4.0 + self.t}
        return self._state(), 0.0, self.t >= self.episode_len, info


class FakeMicroBattleEnv:
    """state[3] = rendered HWC uint8 pixels, 2 actions, scalar reward
    (reference envs/sc2_micro_battle.py)."""

    def __init__(self, episode_len=8):
        self.action_space = _Space(2)
        self.episode_len = episode_len
        self.t = 0
        self.steps_taken = []

    def _state(self):
        return (None, None, None, np.full((16, 16, 3), min(255, self.t * 10), np.uint8))

    def reset(self):
        self.t = 0
        return self._state()

    def step(self, action):
        self.steps_taken.append(action)
        self.t += 1
        return self._state(), float(action) - 0.5, self.t >= self.episode_len, {}


def _both(build):
    return build(jreplay.HostReplayDatasource, jsc2), build(
        lambda *a, **k: treplay.HostReplayDatasource(*a, device="cpu", **k), tsc2)


def test_zergling_pipeline_fills_the_same_buffers():
    def build(cls, mod):
        return cls(FakeZerglingEnv, num_actions=5, num_rewards=4, channels=4,
                   convert_frame=mod.zergling_convert_frame,
                   split_reward=mod.zergling_split_reward,
                   policy=mod.NoopBiasedPolicy(5, mod.ZERGLING_NOOP_ACTION, seed=0),
                   min_buffer_len=2, max_trajectory_len=20, seed=0)

    jds, tds = _both(build)
    for ds in (jds, tds):
        ds._ensure_started = lambda: None   # played synchronously below
        ds.actor.play_episodes(12)
    _same_buffers(tds, jds)
    want, got = jds.get_trajectories(3, 10), tds.get_trajectories(3, 10)
    for w, g in zip(want, got):
        _same(g, w)
    states, rewards, dones, actions = got
    assert states.shape == (3, 10, 4, 8, 8) and rewards.shape == (3, 10, 4)
    # rewards lag one step; post-step entries carry the info channels
    rows = rewards.reshape(-1, 4)
    post = rows[:, 3] > 0
    assert post.any() and (rows[post][:, 1:3] == [2, 3]).all()
    assert (actions == tsc2.ZERGLING_NOOP_ACTION).mean() > 0.7


def test_micro_battle_sync_refill_and_warmup_match_jax():
    made = {"jax": [], "port": []}

    def build(cls, mod):
        key = "jax" if mod is jsc2 else "port"

        def make_env():
            env = FakeMicroBattleEnv()
            made[key].append(env)
            return env

        return cls(make_env, num_actions=2, num_rewards=1, channels=3,
                   convert_frame=mod.micro_battle_convert_frame,
                   warmup_steps=mod.MICRO_BATTLE_WARMUP_STEPS, warmup_action=0,
                   min_buffer_len=1, max_trajectory_len=100, capacity=500,
                   sync_refill_factor=mod.MICRO_BATTLE_REPLAY_FACTOR, seed=0,
                   policy=lambda s, rng=np.random.default_rng(1): int(rng.integers(2)))

    jds, tds = _both(build)
    for b, t in ((4, 6), (9, 5)):
        want, got = jds.get_trajectories(b, t), tds.get_trajectories(b, t)
        for w, g in zip(want, got):
            _same(g, w)
    _same_buffers(tds, jds)
    assert not tds._started            # refilled synchronously, no daemon thread
    assert tds.actor.episodes_played == jds.actor.episodes_played >= 2
    assert made["port"][0].steps_taken == made["jax"][0].steps_taken
    assert made["port"][0].steps_taken[:3] == [0, 0, 0]   # the warm-up no-ops
    ep_states, _, _ = tds.buffer.sample_episode(True)
    assert ep_states[0].max() * 255 >= 3 * 10 - 1e-6     # warm-up frames skipped


def test_sc2_allocation_fails_only_on_the_dependency():
    for name, (game, a, r, c) in tsc2.SC2_GAMES.items():
        ds = tsc2.SC2Datasource(name, seed=0, device="cpu")
        jds = jsc2.SC2Datasource(name, seed=0)
        for attr in ("binary_input_channels", "scalar_output_channels",
                     "conv_input_channels", "sync_refill_factor", "min_buffer_len"):
            assert getattr(ds, attr) == getattr(jds, attr), (name, attr)
        assert (ds.binary_input_channels, ds.scalar_output_channels,
                ds.conv_input_channels) == (a, r, c)
        assert ds.actor.max_trajectory_len == jds.actor.max_trajectory_len
        assert ds.actor.warmup_steps == jds.actor.warmup_steps
        assert ds.buffer.capacity == jds.buffer.capacity
        assert type(ds.actor.policy).__name__ == type(jds.actor.policy).__name__
        for d in (ds, jds):
            with pytest.raises(ImportError, match="sc2env"):
                d.make_env()
    for mod, kw in ((tsc2, {"device": "cpu"}), (jsc2, {})):
        with pytest.raises(ValueError, match="Unknown SC2"):
            mod.SC2Datasource("sc2_nosuch", **kw)


# ---------------------------------------------------------------------------
# allocation and the gym shim
# ---------------------------------------------------------------------------

HOST_NAMES = ["atari", "centipede", "gym:CartPole-v1", "gym:NoSuchGame-v0",
              "sc2_nosuch", *jsc2.SC2_GAMES]


def _outcome(fn):
    try:
        ds = fn()
    except Exception as e:  # noqa: BLE001 - the exception's type is the outcome
        return type(e)
    return (ds.binary_input_channels, ds.scalar_output_channels,
            ds.conv_input_channels, ds.spec.name, ds.spec.height, ds.spec.width)


@pytest.mark.parametrize("name", HOST_NAMES)
def test_allocation_matches_jax(name):
    want = _outcome(lambda: jdatasource.allocate_datasource(name, seed=0))
    got = _outcome(lambda: tdatasource.allocate_datasource(name, seed=0, device="cpu"))
    assert got == want
    if name in ("atari", "centipede"):
        assert got is ImportError          # no ALE in this image: no fall-back
    if name.startswith("sc2_") and name in jsc2.SC2_GAMES:
        assert isinstance(got, tuple)      # allocation works without sc2env


def _hide_gym(monkeypatch):
    for name in ("gym", "gymnasium"):
        monkeypatch.setitem(sys.modules, name, None)   # import now raises


def test_import_gym_backends(monkeypatch):
    t, j = _outcome_gym(tcompat), _outcome_gym(jcompat)
    assert t == j
    _hide_gym(monkeypatch)
    for mod in (tcompat, jcompat):
        with pytest.raises(ImportError, match="neither gym nor gymnasium"):
            mod.import_gym()
    for name in ("gym:CarRacing-v3", "gym:CartPole-v1"):
        assert _outcome(lambda: tdatasource.allocate_datasource(
            name, device="cpu")) is ImportError
        assert _outcome(lambda: jdatasource.allocate_datasource(name)) is ImportError


def _outcome_gym(mod):
    try:
        return mod.import_gym().backend_name
    except ImportError:
        return ImportError


class _NewApiEnv:
    def __init__(self):
        self.action_space = _Space(3)
        self.t = 0

    def reset(self, **kw):
        self.t = 0
        return np.zeros(2) + kw.get("seed", 0), {"info": 1}

    def step(self, a):
        self.t += 1
        return np.full(2, self.t), float(a), self.t == 2, self.t == 3, {"t": self.t}


class _OldApiEnv(_NewApiEnv):
    def reset(self, **kw):
        return super().reset(**kw)[0]

    def step(self, a):
        obs, r, term, trunc, info = super().step(a)
        return obs, r, term, info


def test_legacy_env_adapts_both_apis():
    for env_cls in (_NewApiEnv, _OldApiEnv):
        outs = []
        for mod in (tcompat, jcompat):
            env = mod.LegacyEnv(env_cls())
            run = [env.reset(seed=2)] + [env.step(a) for a in (1, 2, 0)]
            outs.append(run + [env.action_space.n, env.t])
        t, j = outs
        assert repr(t) == repr(j)
        assert all(len(step) == 4 for step in t[1:4])


class _FakeGym:
    """A gym-like module whose ``make`` builds continuous or discrete envs."""
    __name__ = "fakegym"

    def __init__(self, discrete_mode=True, pixels=True):
        self.discrete_mode = discrete_mode
        self.pixels = pixels
        self.calls = []

    def make(self, name, **kwargs):
        self.calls.append(dict(kwargs))
        if kwargs.get("continuous") is False and not self.discrete_mode:
            raise TypeError("unexpected keyword continuous")
        env = types.SimpleNamespace(close=lambda: None)
        env.action_space = (_Space(5) if kwargs.get("continuous") is False
                            else types.SimpleNamespace(shape=(3,)))
        env.observation_space = types.SimpleNamespace(
            shape=(96, 96, 3) if self.pixels else (4,))
        return env


def test_make_discrete_matches_jax():
    for discrete_mode in (True, False):
        outs = []
        for mod in (tpixel, jpixel):
            g = _FakeGym(discrete_mode)
            try:
                env = mod._make_discrete(g, "Car")
                outs.append((env.action_space.n, g.calls))
            except ValueError as e:
                outs.append((str(e), g.calls))
        assert outs[0] == outs[1]
    for mod in (tpixel, jpixel):
        with pytest.raises(ValueError, match="not discrete"):
            mod._make_discrete(_FakeGym(), "Car", continuous=True)


def test_gym_pixel_datasource_on_a_fake_gym(monkeypatch):
    outs = []
    for mod, kw in ((tpixel, {"device": "cpu"}), (jpixel, {})):
        monkeypatch.setattr(mod, "import_gym", lambda: _FakeGym())
        ds = mod.GymPixelDatasource("Car", seed=0, **kw)
        outs.append((ds.binary_input_channels, ds.scalar_output_channels,
                     ds.conv_input_channels, ds.spec.name, ds.env_name,
                     ds.actor.max_trajectory_len, ds.buffer.capacity, ds.min_buffer_len))
        monkeypatch.setattr(mod, "import_gym", lambda: _FakeGym(pixels=False))
        with pytest.raises(ValueError, match="pixel"):
            mod.GymPixelDatasource("Car", **kw)
    assert outs[0] == outs[1] == (5, 2, 3, "gym:Car", "Car", 150, 50, 4)


class _FakeAleEnv:
    """An ALE-like legacy env: RGB frames from a seeded stream, a score now
    and then, ``unwrapped.frameskip``."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.unwrapped = types.SimpleNamespace(frameskip=None, ale="fake")
        self.action_space = _Space(6)
        self.steps = 0

    def reset(self):
        return self.rng.integers(0, 256, (210, 160, 3)).astype(np.uint8)

    def step(self, a):
        self.steps += 1
        obs = self.rng.integers(0, 256, (210, 160, 3)).astype(np.uint8)
        reward = float(self.rng.integers(-1, 2)) if self.steps % 7 == 0 else 0.0
        return obs, reward, self.steps % 11 == 0, {"step": self.steps}

    def close(self):
        pass


@pytest.mark.parametrize("game", ["PongDeterministic-v4", "BreakoutDeterministic-v4"])
def test_multi_environment_matches_jax(monkeypatch, game):
    outs = []
    for mod in (tmake, jmake):
        seeds = iter(range(3))
        fake = types.SimpleNamespace(make=lambda name: _FakeAleEnv(next(seeds)))
        monkeypatch.setattr(mod, "_require_gym", lambda: fake)
        menv = mod.MultiEnvironment(game, batch_size=3)
        assert [e.unwrapped.frameskip for e in menv.envs] == [2, 2, 2]
        assert menv.ale == "fake"
        outs.append([menv.step([1, 2, 3]) for _ in range(4)])
    for (ts, tr, td, ti), (js, jr, jd, ji) in zip(*outs):
        for a, b in zip(ts, js):
            _same(a, b)
        assert tr == jr and td == jd and ti == ji


def test_atari_datasource_on_a_fake_gym(monkeypatch):
    outs = []
    for mod, kw in ((tatari, {"device": "cpu"}), (jatari, {})):
        fake = types.SimpleNamespace(make=lambda name: _FakeAleEnv(0))
        monkeypatch.setattr(mod, "_require_gym_atari",
                            lambda: (fake, _FakeAleEnv(0), "ALE/SpaceInvaders-v5"))
        ds = mod.AtariDatasource(seed=0, **kw)
        env = ds.make_env()
        first = env.reset()
        outs.append((ds.binary_input_channels, ds.spec.name, env._env.steps,
                     ds.convert_frame(first)[0], env.action_space.n))
        env.close()
    (tn, tname, tsteps, tframe, tacts), (jn, jname, jsteps, jframe, jacts) = outs
    assert (tn, tname, tsteps, tacts) == (jn, jname, jsteps, jacts) == (6, "atari", 50, 6)
    _same(tframe, jframe)


class _FakeAtariPy:
    """A stand-in for atari_py: a deterministic ALE."""

    class ALEInterface:
        def __init__(self):
            self.t = 0

        def loadROM(self, path):
            self.rom = path

        def reset_game(self):
            self.t = 0

        def act(self, a):
            self.t += 1
            return float(a == 1 and self.t % 3 == 0)

        def getScreenRGB2(self):
            return np.random.default_rng(self.t).integers(0, 256, (210, 160, 3)).astype(np.uint8)

        def game_over(self):
            return self.t >= 30

        def lives(self):
            return 3

    @staticmethod
    def get_game_path(name):
        return f"/roms/{name}.bin"


def test_centipede_on_a_fake_ale(monkeypatch):
    monkeypatch.setitem(sys.modules, "atari_py", _FakeAtariPy)
    tds = tcent.CentipedeDatasource(seed=3, device="cpu")
    jds = jcent.CentipedeDatasource(seed=3)
    assert (tds.height, tds.width, tds.binary_input_channels) == (96, 64, 18)
    for ds in (tds, jds):
        ds.actor.play_episodes(4)
    _same_buffers(tds, jds)
    assert tcent.benchmark(steps=20) > 0


def test_backends_absent_raise_as_in_jax():
    for fn in (lambda m: m.CentipedeEnv(), lambda m: m.benchmark(5)):
        for mod in (tcent, jcent):
            with pytest.raises(ImportError, match="atari_py"):
                fn(mod)
    for mod in (ttowers, jtowers):
        with pytest.raises(ImportError, match="sc2env"):
            mod.build_dataset(4)


def test_fourtowers_on_a_fake_sc2env(monkeypatch):
    class Towers:
        def __init__(self, map_name):
            self.t = 0

        def reset(self):
            self.t = 0
            return np.zeros((2, 3))

        def step(self, a):
            self.t += 1
            return np.full((2, 3), 10 * a + self.t), 0.0, self.t == 4, {}

    leaf = types.ModuleType("sc2env.environments.simple_towers")
    leaf.SimpleTowersEnvironment = Towers
    for name in ("sc2env", "sc2env.environments"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    monkeypatch.setitem(sys.modules, "sc2env.environments.simple_towers", leaf)
    outs = []
    for mod in (ttowers, jtowers):
        np.random.seed(0)
        outs.append(mod.build_dataset(size=10, num_actions=4))
    for (tb, ta, tn), (jb, ja, jn) in zip(*outs):
        _same(tb, jb)
        _same(ta, ja)
        _same(tn, jn)


def test_play_on_a_host_datasource_raises_as_in_jax():
    """JAX's play loop stacks ``convert_frame`` output as (1, 3, H, W, C),
    but HostReplayDatasource.convert_frame returns the stored channels-first
    frame, so --evaluate on a host env fails in JAX (a fault of the JAX
    package, ROADMAP Queue 3); the port's play raises for the same input."""
    import jax

    from scmgan_tpu.models import world_model as jwm
    from scmgan_tpu_torch.train.checkpoint import params_from_numpy

    jplay = importlib.import_module("scmgan_tpu.agent.play")
    tplay = importlib.import_module("scmgan_tpu_torch.agent.play")

    class Env:
        def __init__(self, *a, **k):
            self.action_space, self.t = _Space(5), 0

        def reset(self):
            self.t = 0
            return np.full((16, 16, 3), 0.1, np.float32)

        def step(self, a):
            self.t += 1
            return np.full((16, 16, 3), 0.1 * self.t, np.float32), 0.0, self.t > 9, {}

    chw = lambda s: np.moveaxis(s, -1, 0)  # noqa: E731
    params = jax.tree.map(np.asarray, jwm.init_world_model(
        jax.random.PRNGKey(0), 16, 5, 2, 3, 3, hidden=16, img_size=16))
    kw = dict(num_actions=5, num_rewards=2, channels=3, convert_frame=chw,
              height=16, width=16)
    play_kw = dict(max_steps=2, rollout_depth=2, lookahead=1, write_video=False,
                   seed=0, verbose=False)
    with pytest.raises(ValueError, match="feature"):
        jplay.play(params, jreplay.HostReplayDatasource(Env, **kw), **play_kw)
    with pytest.raises(RuntimeError, match="channels"):
        tplay.play(params_from_numpy(params._asdict(), device="cpu"),
                   treplay.HostReplayDatasource(Env, device="cpu", **kw), **play_kw)


# ---------------------------------------------------------------------------
# live gymnasium (where it imports)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gym_mod():
    try:
        return tcompat.import_gym()
    except ImportError:
        pytest.skip("neither gym nor gymnasium imports")


def test_live_legacy_wrapper_cartpole(gym_mod):
    env = gym_mod.make("CartPole-v1")
    try:
        obs = env.reset()
        assert isinstance(obs, np.ndarray) and obs.shape == (4,)
        out = env.step(0)
        assert len(out) == 4
        assert isinstance(out[2], bool) and isinstance(out[3], dict)
    finally:
        env.close()


@pytest.fixture(scope="module")
def carracing_ds(gym_mod):
    try:
        gym_mod.make("CarRacing-v3", continuous=False).close()
    except Exception:  # noqa: BLE001 - Box2D or pygame missing
        pytest.skip("CarRacing-v3 unavailable (Box2D missing?)")
    ds = tpixel.GymPixelDatasource("CarRacing-v3", seed=0, max_trajectory_len=24,
                                   capacity=8, min_buffer_len=1, device="cpu")
    try:
        yield ds
    finally:
        ds.close()


def test_live_carracing_contract(carracing_ds):
    ds = carracing_ds
    assert (ds.binary_input_channels, ds.scalar_output_channels,
            ds.conv_input_channels) == (5, 2, 3)
    assert ds.spec.name == "gym:CarRacing-v3" and (ds.spec.height, ds.spec.width) == (64, 64)
    obs, rewards, dones, actions = ds.collect(2, 8)
    assert obs.shape == (2, 8, 64, 64, 3) and obs.device.type == "cpu"
    assert rewards.shape == (2, 8, 2) and dones.shape == actions.shape == (2, 8)
    o = obs.numpy()
    assert np.isfinite(o).all() and o.min() >= 0.0 and o.max() <= 1.0 and o.std() > 0.01
    assert int(actions.min()) >= 0 and int(actions.max()) < 5
    states, *_ = ds.get_trajectories(2, 6)
    assert states.shape == (2, 6, 3, 64, 64)


def test_live_train_step_on_emulator_frames(carracing_ds):
    from scmgan_tpu_torch.config import Config
    from scmgan_tpu_torch.train import trainer
    from scmgan_tpu_torch.train.losses import LossNoise

    ds = carracing_ds
    cfg = Config(env="gym:CarRacing-v3", latent_dim=4, hidden_dim=16, batch_size=2,
                 train_iters=10, horizon_min=3, horizon_max=3)
    g = torch.Generator().manual_seed(0)
    state = trainer.init_train_state(cfg, ds.spec, g)
    batch = ds.collect(cfg.batch_size, 3, generator=g)
    state2, metrics = trainer.make_train_step(cfg, 3)(state, batch, LossNoise(g), 0.5, 0.0)
    assert np.isfinite(float(metrics["loss"]))
    assert state2.step == state.step + 1
