"""The port's gridworld and betterpong envs, raster helpers, ``HostEnv``,
``get_trajectories`` and ``policy="repeat"`` (scmgan_tpu_torch.envs,
scmgan_tpu_torch.data) against scmgan_tpu's; and the free-run evaluation on
the 4-action bundles gridworld_cf and pong_cf against scmgan_tpu.analysis.mse.

Env steps have no randomness here: from the same state (the JAX package's
resets, injected) and the same actions the next state, reward, done and
render agree exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.analysis import mse as jmse
from scmgan_tpu.data import allocate_datasource as jallocate
from scmgan_tpu.envs import base as jbase
from scmgan_tpu.envs import betterpong as jbp
from scmgan_tpu.envs import gridworld as jgw
from scmgan_tpu.envs import raster as jraster
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu_torch.analysis import mse as tmse
from scmgan_tpu_torch.data.datasource import allocate_datasource
from scmgan_tpu_torch.envs import base as tbase
from scmgan_tpu_torch.envs import betterpong as tbp
from scmgan_tpu_torch.envs import gridworld as tgw
from scmgan_tpu_torch.envs import raster as traster
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.train.checkpoint import load_model

REPO = os.path.join(os.path.dirname(__file__), "..")
B, STEPS = 4, 40
ENVS = {"gridworld": (jgw, tgw), "pong": (jbp, tbp)}
# The free-run test's tolerances (test_torch_port_free_run.py): f32 convs
# summed in another order, and the port's decoder on the CPU is the
# kernel's plain bf16 version.
RTOL, ATOL, BF16_RTOL = 1e-4, 1e-7, 1e-2


def to_torch_state(module, jstate):
    return module.State(*(torch.from_numpy(np.array(x, dtype=np.int64))
                          for x in jstate))


def assert_state_equal(ts, js):
    for name, t, j in zip(type(ts)._fields, ts, js):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def run_both(jmod, tmod, jstate, steps, seed):
    """Step both envs from ``jstate`` under the same random actions and
    hold the state, reward, done and frame equal at every step."""
    ts = to_torch_state(tmod, jstate)
    jstep = jax.jit(jax.vmap(jmod.step))
    jrender = jax.jit(jax.vmap(jmod.render))
    b = ts[0].shape[0]
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    rng = np.random.default_rng(seed)
    rewards = []
    np.testing.assert_array_equal(tmod.render(ts).numpy(), np.asarray(jrender(jstate)))
    for _ in range(steps):
        actions = rng.integers(0, jmod.NUM_ACTIONS, b)
        jstate, jr, jd = jstep(jstate, jnp.asarray(actions, jnp.int32), keys)
        ts, tr, td = tmod.step(ts, torch.from_numpy(actions), None)
        assert_state_equal(ts, jstate)
        assert tr.dtype == torch.float32 and tr.shape == (b, 1)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(tmod.render(ts).numpy(), np.asarray(jrender(jstate)))
        rewards.append(tr.numpy())
    return np.concatenate(rewards)


@pytest.mark.parametrize("env", sorted(ENVS))
def test_step_render_reward_match_jax(env):
    """40 random steps from JAX's resets: walls, paddles and scoring."""
    jmod, tmod = ENVS[env]
    jstate = jax.vmap(jmod.reset)(jax.random.split(jax.random.PRNGKey(7), B))
    rewards = run_both(jmod, tmod, jstate, STEPS, seed=1)
    assert (rewards != 0).any()


def test_pong_velocity_seeding_quirk_matches_jax():
    """The reference's Higgins simulator seeds both ball velocities from the
    left paddle's factor (envs/betterpong.py:164-165): velocities outside
    ``_VELOCITIES``, 0 among them (a dead ball) and up to the court's size.
    The dynamics take them as the JAX package's do."""
    factors = np.array([[0.0, 0.3, 0.5, 0.5, 0, 0], [0.04, 0.9, 0.2, 0.7, 0, 0],
                        [0.5, 0.5, 0.9, 0.1, 0, 0], [1.0, 0.0, 0.4, 0.3, 0, 0]],
                       np.float32)
    z = jnp.asarray(factors)
    r = jbp._rescale
    jstate = jbp.State(
        left_y=r(z[:, 0], 0, jbp.GAME_SIZE), right_y=r(z[:, 1], 0, jbp.GAME_SIZE),
        ball_x=r(z[:, 2], jbp.MARGIN_X, jbp.GAME_SIZE - jbp.MARGIN_X),
        ball_y=r(z[:, 3], jbp.MARGIN_Y, jbp.GAME_SIZE - jbp.MARGIN_Y),
        vel_x=r(z[:, 0], 0, jbp.GAME_SIZE), vel_y=r(z[:, 0], 0, jbp.GAME_SIZE))
    assert set(np.asarray(jstate.vel_x).tolist()) == {0, 3, 32, 64}
    run_both(jbp, tbp, jstate, STEPS, seed=2)


@pytest.mark.parametrize("case", range(3))
def test_raster_helpers_match_jax(case):
    rng = np.random.default_rng(case)
    n = 16
    y0, y1, x0, x1 = (rng.integers(-n - 2, n + 3, B) for _ in range(4))
    cx, cy, hw, hh = (rng.integers(-3, n + 3, B), rng.integers(-3, n + 3, B),
                      rng.integers(0, 4, B), rng.integers(0, 4, B))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = traster.slice_rect_mask(n, n, t(y0), t(y1), t(x0), t(x1)).numpy()
    got_rect = traster.rect_mask(n, n, t(cx), t(cy), t(hw), t(hh)).numpy()
    frame = rng.random((B, n, n, 3)).astype(np.float32)
    got_paint = traster.paint(torch.from_numpy(frame), 1, torch.from_numpy(got_rect))
    for i in range(B):
        np.testing.assert_array_equal(got[i], np.asarray(jraster.slice_rect_mask(
            n, n, y0[i], y1[i], x0[i], x1[i])))
        want_rect = np.asarray(jraster.rect_mask(n, n, cx[i], cy[i], hw[i], hh[i]))
        np.testing.assert_array_equal(got_rect[i], want_rect)
        np.testing.assert_array_equal(got_paint[i].numpy(), np.asarray(
            jraster.paint(jnp.asarray(frame[i]), 1, jnp.asarray(want_rect))))
    # a Python int broadcast over the batch, as the paddles' columns are
    np.testing.assert_array_equal(
        traster.rect_mask(n, n, 5, t(cy), 1, 8).numpy()[0],
        np.asarray(jraster.rect_mask(n, n, 5, cy[0], 1, 8)))


@pytest.mark.parametrize("env", sorted(ENVS))
def test_repeat_policy_and_rollout_replay(env):
    """``policy="repeat"``: env i always takes action i mod A, as JAX's
    ``_policy_actions``; the rollout's frames replay through step from the
    starts the generator drew."""
    spec = tbase.get_env(env)
    gen = torch.Generator().manual_seed(3)
    obs, rewards, dones, actions = tbase.rollout(spec, gen, B + 2, 6, policy="repeat")
    want = np.asarray(jbase._policy_actions(jbase.get_env(env), None, B + 2, "repeat"))
    np.testing.assert_array_equal(actions.numpy(), np.repeat(want[:, None], 6, axis=1))
    gen = torch.Generator().manual_seed(3)
    state = spec.reset(B + 2, "cpu", gen)
    for t in range(6):
        state, r, _ = spec.step(state, torch.from_numpy(want.astype(np.int64)), None)
        np.testing.assert_array_equal(obs[:, t].numpy(), spec.render(state).numpy())
        np.testing.assert_array_equal(rewards[:, t].numpy(), r.numpy())
        spec.reset(B + 2, "cpu", gen)   # the auto-reset's draw
    with pytest.raises(ValueError, match="unknown policy"):
        tbase.rollout(spec, gen, 2, 2, policy="sideways")


@pytest.mark.parametrize("env", sorted(ENVS))
def test_host_env_matches_jax(env):
    """A HostEnv started from JAX's HostEnv's first reset: the same frames,
    summed rewards, done flags and per-channel info, step by step."""
    jenv = jbase.HostEnv(jbase.get_env(env), seed=4)
    jobs = jenv.reset()
    _, tmod = ENVS[env]
    start = to_torch_state(tmod, jax.tree.map(lambda x: x[None], jenv.state))
    tenv = tbase.HostEnv(tbase.get_env(env), device="cpu", start_state=start)
    np.testing.assert_array_equal(tenv.reset(), jobs)
    rng = np.random.default_rng(5)
    for a in rng.integers(0, 4, 30):
        got, want = tenv.step(int(a)), jenv.step(int(a))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    # without an injected start, the reset is drawn from the generator
    again = tbase.HostEnv(tbase.get_env(env), seed=9, device="cpu")
    np.testing.assert_array_equal(
        again.reset(), tbase.HostEnv(tbase.get_env(env), seed=9, device="cpu").reset())


@pytest.mark.parametrize("env", sorted(ENVS))
def test_get_trajectories_make_env_convert_frame(env):
    ds = allocate_datasource(env, seed=2, device="cpu")
    jds = jallocate(env, seed=2)
    got = ds.get_trajectories(3, 5)
    want = jds.get_trajectories(3, 5)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        assert g.shape == w.shape and g.dtype.kind == w.dtype.kind
    assert got[0].shape == (3, 5, 3, ds.spec.height, ds.spec.width)
    assert (ds.binary_input_channels, ds.scalar_output_channels) == (4, 1)
    env_a, env_b = ds.make_env(screen_size=512), ds.make_env()
    assert isinstance(env_a, tbase.HostEnv) and env_a.device.type == "cpu"
    frames = [env_a.reset() for _ in range(4)], [env_b.reset() for _ in range(4)]
    assert any(not np.array_equal(a, b) for a, b in zip(*frames))  # fresh seeds
    obs = env_a.reset()
    assert ds.convert_frame(obs) == (obs, obs)


# ---------------------------------------------------------------------------
# the free-run evaluation on the 4-action bundles
# ---------------------------------------------------------------------------

class _Stub:
    """A datasource that hands out one fixed batch."""

    binary_input_channels = 4

    def __init__(self, batch):
        self.batch = batch

    def collect(self, batch_size, timesteps, **kw):
        return self.batch


FREE_RUN = [("gridworld_cf", "gridworld"), ("pong_cf", "pong")]
# gridworld_cf predicts its frames almost exactly: its pixel MSE is about
# 1e-8, below the free-run test's absolute floor, so the f32 comparison
# holds the relative error alone.  Through the port's default decoder (bf16
# on the CPU) a logit near -15 moves by up to 2^-8 of itself, which moves
# such a sigmoid tail by up to about 10%: the pixel curve of the default
# path gets an absolute floor of 1e-9 beside the 1% of the free-run test.
PIXEL_BF16_ATOL = 1e-9


@pytest.mark.parametrize("bundle,env", FREE_RUN)
def test_measure_prediction_mse_4_actions(bundle, env, tmp_path):
    """conv1 with 4 actions (20 input channels) on trained weights, on a
    batch of the env's own trajectories (B = 4, 8 steps): the four curves
    per horizon through the port's f32 transition and decoder, and the
    port's ``measure_prediction_mse`` (its default decoder) end to end."""
    model = load_model(os.path.join(REPO, "pretrained_models", bundle), device="cpu")
    jax_model = jwm.WorldModel(**{n: jax.tree.map(lambda t: t.numpy(), getattr(model, n))
                                  for n in jwm.WorldModel._fields})
    batch = tuple(np.array(x) for x in jbase.rollout(
        jbase.get_env(env), jax.random.PRNGKey(11), 4, 8))
    tbatch = tuple(torch.from_numpy(x) for x in batch)
    kw = dict(train_iter=1, timesteps=8, batch_size=4, make_plots=False)
    want = jmse.measure_prediction_mse(
        jax_model, _Stub(tuple(jnp.asarray(x) for x in batch)), out_dir=str(tmp_path), **kw)
    transition = lambda z, a: twm.transition(model.transition, z, a)  # noqa: E731
    stats = tmse._free_run_stats(model, tbatch, 4, transition_fn=transition,
                                 decode_fn=lambda z: twm.decode(model.decoder, z))
    for name, w, g in zip(["pixel mse", "pixel std", "reward mse", "reward std"], want,
                          stats):
        assert g.shape == (6,)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=0, err_msg=name)
    got = tmse.measure_prediction_mse(model, _Stub(tbatch), out_dir=str(tmp_path),
                                      transition_fn=transition, **kw)
    assert len(got[0]) == len(want[0]) == 6
    np.testing.assert_allclose(got[0], want[0], rtol=BF16_RTOL, atol=PIXEL_BF16_ATOL)
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL, atol=ATOL)  # reward
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL, atol=ATOL)
