"""The port's play loops and oracle (scmgan_tpu_torch.agent.{play,
play_device,oracle}) against scmgan_tpu.agent's on the CPU, on the trained
gridworld_cf weights: 2 episodes x 12 steps, lookahead 1, depth 3.

Both sides start from the JAX package's episode starts (HostEnv's first
reset for a seed) and step the same deterministic env.  The hard-threshold
beam is chaotic, so where JAX's top two scores lie within the score
tolerance the step is teacher-forced: the port takes JAX's action.  Such
steps are counted and printed; at every other step the port's own argmax
must be JAX's.  The port plans on the plain f32 transition here.
"""

import dataclasses
import importlib
import os

import jax
import numpy as np
import pytest
import torch

from scmgan_tpu.agent import oracle as joracle
from scmgan_tpu.data import allocate_datasource as jallocate
from scmgan_tpu.envs import base as jbase
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu_torch.agent import mpc as tmpc
from scmgan_tpu_torch.agent import oracle as toracle
from scmgan_tpu_torch.agent.play import play
from scmgan_tpu_torch.agent.play_device import play_on_device
from scmgan_tpu_torch.data.datasource import allocate_datasource
from scmgan_tpu_torch.envs import base as tbase
from scmgan_tpu_torch.envs import betterpong as tbp
from scmgan_tpu_torch.envs import gridworld as tgw
from scmgan_tpu_torch.envs import minipacman as tmp
from scmgan_tpu_torch.train.checkpoint import load_model
from test_torch_port_env import _jax_noise

REPO = os.path.join(os.path.dirname(__file__), "..")
MAX_STEPS, LOOKAHEAD, DEPTH = 12, 1, 3
SEEDS = (0, 1)
STALL_PATIENCE = 2
# Scores as in test_torch_port_mpc.py: f32 on both sides in another order.
SCORE_RTOL = SCORE_ATOL = 1e-5
KW = dict(max_steps=MAX_STEPS, rollout_depth=DEPTH, lookahead=LOOKAHEAD, verbose=False)
STATES = {"gridworld": tgw.State, "pong": tbp.State, "minipacman": tmp.State}
# the module: scmgan_tpu.agent's package namespace exports the function
jplay = importlib.import_module("scmgan_tpu.agent.play")


def torch_state(env, jstate):
    """JAX's state as the port's: int64 integers, booleans kept."""
    return STATES[env](*(torch.from_numpy(
        np.array(x, dtype=bool if np.asarray(x).dtype == bool else np.int64)) for x in jstate))


class JaxRecordingEnv(jbase.HostEnv):
    """The JAX package's HostEnv, recording its first start and every action."""

    def reset(self):
        obs = super().reset()
        if not hasattr(self, "start"):
            self.start = jax.tree.map(lambda x: np.array(x)[None], self.state)
        return obs

    def step(self, action):
        self.actions = getattr(self, "actions", []) + [int(action)]
        return super().step(action)


class RecordingEnv(tbase.HostEnv):
    def step(self, action):
        self.actions = getattr(self, "actions", []) + [int(action)]
        return super().step(action)


def jax_episode(jax_model, seed, stall_patience, tmp_path):
    """JAX's host play loop, recording each step's scores."""
    jds = jallocate("gridworld")
    env = JaxRecordingEnv(jds.spec, seed=seed)
    scores = []
    plan = jplay.rollout_reward_table
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jplay, "rollout_reward_table",
                   lambda *a, **k: scores.append(np.asarray(plan(*a, **k))) or scores[-1])
        reward, t = jplay.play(jax_model, jds, out_dir=str(tmp_path), seed=seed,
                               stall_patience=stall_patience, env=env, write_video=False,
                               **KW)
    return {"start": env.start, "scores": scores, "actions": env.actions[2:],
            "reward": reward, "t": t}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    model = load_model(os.path.join(REPO, "pretrained_models", "gridworld_cf"),
                       device="cpu")
    jax_model = jwm.WorldModel(**{n: jax.tree.map(lambda t: t.numpy(), getattr(model, n))
                                  for n in jwm.WorldModel._fields})
    tmp = tmp_path_factory.mktemp("jax_play")
    refs = {(s, 0): jax_episode(jax_model, s, 0, tmp) for s in SEEDS}
    refs[(0, STALL_PATIENCE)] = jax_episode(jax_model, 0, STALL_PATIENCE, tmp)
    return model, jax_model, refs


class Teacher:
    """``mpc.best_action`` for the play loops under test: each call is one
    step of every episode.  It holds the port's scores to JAX's, forces JAX's
    action where JAX's top two scores lie within the tolerance, and else
    requires the port's own argmax to be JAX's.  With ``taken`` it returns
    the action JAX's episode took, its stall kicks included."""

    def __init__(self, refs, taken=False):
        self.refs, self.taken, self.step, self.forced = refs, taken, 0, 0

    def __call__(self, scores):
        actions = []
        for e, ref in enumerate(self.refs):
            want, got = ref["scores"][self.step], scores[e].numpy()
            np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
            top = np.sort(want)[-2:]
            if top[1] - top[0] <= SCORE_ATOL + SCORE_RTOL * abs(top[1]):
                self.forced += 1
            else:
                assert int(np.argmax(got)) == int(np.argmax(want))
            actions.append(ref["actions"][self.step] if self.taken
                           else int(np.argmax(want)))
        self.step += 1
        return torch.tensor(actions)

    def report(self, label):
        n = self.step * len(self.refs)
        print(f"{label}: {self.forced} of {n} steps teacher-forced at a near-tie")


@pytest.mark.parametrize("seed", SEEDS)
def test_play_matches_jax_host_loop(setup, seed, tmp_path, monkeypatch):
    model, _, refs = setup
    ref = refs[(seed, 0)]
    teacher = Teacher([ref])
    monkeypatch.setattr(tmpc, "best_action", teacher)
    env = RecordingEnv(tbase.get_env("gridworld"), device="cpu",
                       start_state=torch_state("gridworld", ref["start"]))
    reward, t = play(model, allocate_datasource("gridworld", device="cpu"),
                     out_dir=str(tmp_path), seed=seed, stall_patience=0, env=env,
                     write_video=bool(seed), dtype=torch.float32, **KW)
    teacher.report(f"play, seed {seed}")
    assert env.actions[2:] == ref["actions"]
    assert (reward, t) == (ref["reward"], ref["t"]) == (reward, MAX_STEPS + 1)
    scores = [f for f in os.listdir(tmp_path) if f.startswith("evaluation_metrics_")]
    assert len(scores) == 1
    with open(tmp_path / scores[0]) as f:
        assert f.read() == f"Finished at t={t} with cumulative reward {reward}\n"
    videos = [f for f in os.listdir(tmp_path) if f.startswith("SimpleRolloutAgent-")]
    assert len(videos) == (1 if seed else 0)


def test_stall_kick_matches_jax_host_loop(setup, tmp_path, monkeypatch):
    """At the right wall the frame stops changing; after STALL_PATIENCE
    such steps both loops kick with np.random.default_rng(seed)'s choice."""
    model, _, refs = setup
    ref = refs[(0, STALL_PATIENCE)]
    assert ref["actions"] != refs[(0, 0)]["actions"]       # the kick happened
    teacher = Teacher([ref])
    monkeypatch.setattr(tmpc, "best_action", teacher)
    env = RecordingEnv(tbase.get_env("gridworld"), device="cpu",
                       start_state=torch_state("gridworld", ref["start"]))
    reward, t = play(model, allocate_datasource("gridworld", device="cpu"),
                     out_dir=str(tmp_path), seed=0, stall_patience=STALL_PATIENCE,
                     env=env, write_video=False, dtype=torch.float32, **KW)
    teacher.report("play with stall kicks")
    assert env.actions[2:] == ref["actions"]
    assert (reward, t) == (ref["reward"], ref["t"])


def test_play_on_device_matches_jax(setup, tmp_path, monkeypatch):
    """Three episodes in one batched loop: JAX's two plain episodes and its
    stall-kick episode, whose kicks (drawn from numpy on JAX's host loop)
    the teacher hands in as the actions taken.  Scores, actions, rewards
    and step counts are JAX's."""
    model, _, refs = setup
    keys = [(s, 0) for s in SEEDS] + [(0, STALL_PATIENCE)]
    teacher = Teacher([refs[k] for k in keys], taken=True)
    monkeypatch.setattr(tmpc, "best_action", teacher)
    start = torch_state("gridworld", jax.tree.map(
        lambda *x: np.concatenate(x), *(refs[k]["start"] for k in keys)))
    got_r, got_t = play_on_device(model, allocate_datasource("gridworld", device="cpu"),
                                  episodes=len(keys), stall_patience=0, seed0=SEEDS[0],
                                  out_dir=str(tmp_path), start_state=start,
                                  dtype=torch.float32, **KW)
    teacher.report("play_on_device")
    assert teacher.step == MAX_STEPS - 1
    assert got_r == [refs[k]["reward"] for k in keys]
    assert got_t == [refs[k]["t"] for k in keys]
    names = sorted(os.listdir(tmp_path))
    assert len(names) == len(keys) and names[-1].endswith(f"_{SEEDS[0] + 2}.txt")


def test_play_options_run_on_the_port(tmp_path):
    """The options that draw from the port's generator (random tail,
    sampled tail, stall kick) and the int8 beam, on the default bf16
    packing: a run repeats for a seed."""
    model = load_model(os.path.join(REPO, "pretrained_models", "gridworld_cf"),
                       device="cpu")
    ds = allocate_datasource("gridworld", device="cpu")
    kw = dict(episodes=2, max_steps=3, rollout_depth=1, lookahead=0, stall_patience=1,
              seed0=3, verbose=False, rollout_policy="random", rollout_samples=2)
    first = play_on_device(model, ds, **kw)
    assert first == play_on_device(model, ds, **kw)
    assert first[1] == [4, 4]
    reward, t = play(model, ds, max_steps=3, rollout_depth=1, lookahead=0, seed=1,
                     use_int8=True, verbose=False, write_video=False,
                     env=tbase.HostEnv(ds.spec, seed=1, device="cpu"), out_dir=str(tmp_path))
    assert t == 4 and reward in (-2.0, -1.0, 0.0, 1.0, 2.0)


# ---------------------------------------------------------------------------
# the oracle: integer envs, so everything is exactly equal
# ---------------------------------------------------------------------------

class OracleNoise(tmpc.PlanNoise):
    """The random tails of ``oracle_rollout_scores`` for E states as JAX
    draws them when handed one key a state (oracle.py:64-66)."""

    def __init__(self, key):
        super().__init__(torch.Generator())
        self.key = key

    def tail_actions(self, shape, num_actions):
        """State e's table from the e-th of ``split(key, E)``."""
        return torch.from_numpy(np.stack([np.array(jax.random.randint(
            k, tuple(shape[1:]), 0, num_actions), dtype=np.int64)
            for k in jax.random.split(self.key, shape[0])]))


@pytest.mark.parametrize("env", ["gridworld", "pong"])
def test_oracle_rollout_scores_match_jax(env):
    jspec, tspec = jbase.get_env(env), tbase.get_env(env)
    jstates = jax.vmap(jspec.reset)(jax.random.split(jax.random.PRNGKey(2), 3))
    got = toracle.oracle_rollout_scores(tspec, torch_state(env, jstates), 4, 2, 12)
    for e in range(3):
        want = joracle.oracle_rollout_scores(
            jspec, jax.tree.map(lambda x: x[e], jstates), 4, 2, 12)
        np.testing.assert_array_equal(got[e].numpy(), np.asarray(want))
    # random tails (one table per state) with two replicas, caution weight
    noise = OracleNoise(jax.random.PRNGKey(4))
    got = toracle.oracle_rollout_scores(tspec, torch_state(env, jstates), 4, 1, 5,
                                        "random", 0.1, noise=noise, samples=2)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    for e in range(3):
        want = joracle.oracle_rollout_scores(
            jspec, jax.tree.map(lambda x: x[e], jstates), 4, 1, 5, "random", 0.1,
            key=keys[e], samples=2)
        np.testing.assert_array_equal(got[e].numpy(), np.asarray(want))


def test_oracle_rollout_scores_minipacman_match_jax():
    """A stochastic env that ends: minipacman's ghosts draw from JAX's keys
    (``k, sub = split(k)`` a step, one key a beam state, oracle.py:73-77),
    replayed through the spec's ``draw_noise``; two replicas a plan; with
    the ghosts beside pacman every plan is caught early and stops counting
    reward."""
    jspec = jbase.get_env("minipacman")
    jstate = jspec.reset(jax.random.PRNGKey(0))
    # the three ghosts beside pacman (12, 7): up, left and right
    jstate = jstate._replace(ghost_r=jax.numpy.array([11, 12, 12]),
                             ghost_c=jax.numpy.array([7, 6, 8]))
    width, samples, depth = 5 ** 3, 2, 12
    k, step_keys = jax.random.PRNGKey(0), []
    for _ in range(depth + 1):
        k, sub = jax.random.split(k)
        step_keys.append(jax.random.split(sub, width * samples))
    replay = iter(step_keys)
    spec = dataclasses.replace(tbase.get_env("minipacman"),
                               draw_noise=lambda b, g: _jax_noise(next(replay)))
    want = joracle.oracle_rollout_scores(jspec, jstate, 5, 2, depth, samples=samples)
    got = toracle.oracle_rollout_scores(
        spec, torch_state("minipacman", jax.tree.map(lambda x: np.array(x)[None], jstate)),
        5, 2, depth, samples=samples)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # every plan is caught within two steps: at most two foods (10 each,
    # with the tradeoff) less the catch (1)
    assert np.asarray(want).max() < 20


@pytest.mark.parametrize("env,max_steps", [("gridworld", MAX_STEPS), ("pong", 60)])
def test_oracle_episodes_match_jax(env, max_steps):
    """The reference beam (lookahead 2, depth 12) with the true dynamics:
    host episodes and the batched loop, from JAX's starts."""
    jspec, tspec = jbase.get_env(env), tbase.get_env(env)
    starts = []
    for s in SEEDS:
        want = joracle.play_oracle(jspec, max_steps=max_steps, seed=s)
        jenv = jbase.HostEnv(jspec, seed=s)
        jenv.reset()
        starts.append(jax.tree.map(lambda x: np.array(x)[None], jenv.state))
        tenv = tbase.HostEnv(tspec, device="cpu", start_state=torch_state(env, starts[-1]))
        assert toracle.play_oracle(tspec, max_steps=max_steps, env=tenv) == want
    want = joracle.play_oracle_on_device(jspec, episodes=len(SEEDS), max_steps=max_steps,
                                         seed0=SEEDS[0], verbose=False)
    start = torch_state(env, jax.tree.map(lambda *x: np.concatenate(x), *starts))
    got = toracle.play_oracle_on_device(tspec, episodes=len(SEEDS), max_steps=max_steps,
                                        device="cpu", start_state=start, verbose=False)
    assert got == (want[0], list(want[1]))
    if env == "gridworld":
        assert min(got[0]) > 0


def test_agent_entry_points_default_to_the_card():
    """Without ``device=`` the env adapter and the oracle ask for CUDA: with
    no card they raise instead of running on the CPU (the play loops run
    on the model's device)."""
    spec = tbase.get_env("gridworld")
    if torch.cuda.is_available():
        assert tbase.HostEnv(spec).device.type == "cuda"
        return
    for call in (lambda: tbase.HostEnv(spec),
                 lambda: toracle.play_oracle_on_device(spec, episodes=1, max_steps=2),
                 lambda: toracle.play_oracle(spec, max_steps=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
