"""The rest of the port's synthetic env zoo (scmgan_tpu_torch.envs.{boxes,
pong_family,roomba,gameoflife}) against scmgan_tpu's, and the free-run
evaluation on the shipped 64x64 bundles boxes_cf (1 colour) and
minipong_cf (3 colours) against scmgan_tpu.analysis.mse.

Env steps draw nothing: from the same state (the JAX package's resets,
injected) and the same actions, the next state, reward, done and render
agree exactly.  One exception, rotating_boxes: its corners come from f32
sin/cos, which XLA and torch may round differently in the last bit, so a
pixel whose edge cross product is within ``EDGE_EPS`` of 0 in JAX's frame
may differ; no other pixel may.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu import envs as jenvs
from scmgan_tpu.analysis import mse as jmse
from scmgan_tpu.envs import base as jbase
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu_torch import envs as tenvs
from scmgan_tpu_torch.analysis import mse as tmse
from scmgan_tpu_torch.envs import base as tbase
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.train.checkpoint import load_model
from test_torch_port_env_flagship import ATOL, BF16_RTOL, PIXEL_BF16_ATOL, RTOL

REPO = os.path.join(os.path.dirname(__file__), "..")
NEW_ENVS = ["boxes", "gameoflife", "hardpong", "mediumpong", "minipong", "multibox",
            "realpong", "roomba", "roomba1", "rotating_boxes", "staticpong", "superpong"]
B, STEPS, SIM_ROWS = 4, 40, 64
EDGE_EPS = 1e-3
SPEC_FIELDS = ("name", "num_actions", "num_rewards", "channels", "height", "width",
               "true_latent_dim")


def to_torch_state(template, jstate):
    """JAX's state as the port's: ints as int64, floats as f32, bools kept."""
    def conv(x):
        x = np.asarray(x)
        dtype = {"i": np.int64, "f": np.float32, "b": np.bool_}[x.dtype.kind]
        return torch.from_numpy(x.astype(dtype))
    return type(template)(*(conv(x) for x in jstate))


def assert_state_equal(ts, js):
    for name, t, j in zip(type(ts)._fields, ts, js):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)


def rotbox_edge(width, x, y, rotation):
    """(B, H, W): where some edge's cross product of JAX's rotated square
    (scmgan_tpu/envs/boxes.py::_rotbox_frame, the same f32 ops) lies within
    EDGE_EPS of 0."""
    rot = jnp.asarray(rotation).astype(jnp.float32)[:, None]
    angles = rot + jnp.asarray(np.array([1, 3, 5, 7]) * np.pi / 4, jnp.float32)
    width = jnp.asarray(width, jnp.float32)[:, None]
    cy = jnp.asarray(y).astype(jnp.float32)[:, None] + width * jnp.sin(angles)
    cx = jnp.asarray(x).astype(jnp.float32)[:, None] + width * jnp.cos(angles)
    rows = jnp.arange(64, dtype=jnp.float32)[None, :, None]
    cols = jnp.arange(64, dtype=jnp.float32)[None, None, :]
    near = jnp.zeros((rot.shape[0], 64, 64), bool)
    for k in range(4):
        ax, ay = cx[:, k, None, None], cy[:, k, None, None]
        bx, by = cx[:, (k + 1) % 4, None, None], cy[:, (k + 1) % 4, None, None]
        near |= jnp.abs((bx - ax) * (rows - ay) - (by - ay) * (cols - ax)) < EDGE_EPS
    return np.asarray(near)


def assert_frames_equal(got, want, edge=None, label=""):
    """Exact, except (where ``edge`` is given) on JAX's edge pixels; returns
    the number of pixels that differ there."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    diff = (got != want).any(axis=-1)
    if edge is None:
        assert not diff.any(), f"{label}: {int(diff.sum())} pixels differ"
        return 0
    assert not (diff & ~edge).any(), \
        f"{label}: {int((diff & ~edge).sum())} pixels off the edges differ"
    return int(diff.sum())


def test_available_envs_match_jax():
    assert tenvs.available_envs() == jenvs.available_envs()
    assert len(tenvs.available_envs()) == 16
    with pytest.raises(ValueError, match="Unknown environment"):
        tbase.get_env("gym:CarRacing-v3")


@pytest.mark.parametrize("env", NEW_ENVS)
def test_spec_fields_match_jax(env):
    ts, js = tbase.get_env(env), jbase.get_env(env)
    for field in SPEC_FIELDS:
        assert getattr(ts, field) == getattr(js, field), field
    assert (ts.simulator is None) == (js.simulator is None)
    assert ts.draw_noise(B, torch.Generator()) is None


@pytest.mark.parametrize("env", NEW_ENVS)
def test_step_render_reward_done_match_jax(env, capsys):
    """40 random steps from JAX's resets, each state, reward, done flag and
    frame held equal."""
    ts_spec, js_spec = tbase.get_env(env), jbase.get_env(env)
    jstate = jax.vmap(js_spec.reset)(jax.random.split(jax.random.PRNGKey(7), B))
    template = ts_spec.reset(1, "cpu", torch.Generator().manual_seed(0))
    ts = to_torch_state(template, jstate)
    jstep, jrender = jax.jit(jax.vmap(js_spec.step)), jax.jit(jax.vmap(js_spec.render))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    rng = np.random.default_rng(1)
    edge = (lambda s: rotbox_edge(s.width, s.x, s.y, s.rotation)) \
        if env == "rotating_boxes" else (lambda s: None)
    flips = assert_frames_equal(ts_spec.render(ts), jrender(jstate), edge(jstate), "reset")
    rewards, dones = [], []
    for t in range(STEPS):
        actions = rng.integers(0, js_spec.num_actions, B)
        jstate, jr, jd = jstep(jstate, jnp.asarray(actions, jnp.int32), keys)
        ts, tr, td = ts_spec.step(ts, torch.from_numpy(actions), None)
        assert_state_equal(ts, jstate)
        assert tr.dtype == torch.float32 and tr.shape == (B, 1)
        assert td.dtype == torch.bool and td.shape == (B,)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        flips += assert_frames_equal(ts_spec.render(ts), jrender(jstate), edge(jstate),
                                     f"step {t}")
        rewards.append(tr.numpy())
        dones.append(td.numpy())
    with capsys.disabled():
        if env == "rotating_boxes":
            print(f"\n[rotating_boxes] {flips} edge pixels differ over {STEPS + 1} x {B} frames")
    if env in ("roomba", "realpong"):   # the pushes and the scores were reached
        assert np.concatenate(rewards).any()
    if env == "realpong":
        assert np.concatenate(dones).any()


@pytest.mark.parametrize("env", [e for e in NEW_ENVS if jbase.get_env(e).simulator])
def test_simulator_matches_jax(env):
    """64 factor rows from a numpy generator (f64, as the Higgins metric
    hands them over)."""
    ts_spec, js_spec = tbase.get_env(env), jbase.get_env(env)
    factors = np.random.default_rng(5).uniform(size=(SIM_ROWS, ts_spec.true_latent_dim))
    got, want = ts_spec.simulator(factors), js_spec.simulator(factors)
    assert isinstance(got, np.ndarray)
    edge = None
    if env == "rotating_boxes":
        z = jnp.asarray(factors, jnp.float32)
        i = lambda v: v.astype(jnp.int32)  # noqa: E731
        edge = rotbox_edge(i(z[:, 0] * 15).astype(jnp.float32) + 5, i(z[:, 2] * 26) + 20,
                           i(z[:, 3] * 26) + 20, i(z[:, 4] * 90))
    assert_frames_equal(got, want, edge, env)
    assert got.any()


@pytest.mark.parametrize("env", NEW_ENVS)
def test_repeat_policy_and_rollout_replay(env):
    """``policy="repeat"``: env i always takes action i mod A, as JAX's
    ``_policy_actions``, each emitted action the NEXT one; the rollout's
    frames replay through step from the starts the generator drew, a
    finished episode (realpong's score) restarting from the next draw."""
    spec, n, t_steps = tbase.get_env(env), B + 2, 30
    gen = torch.Generator().manual_seed(3)
    obs, rewards, dones, actions = tbase.rollout(spec, gen, n, t_steps, policy="repeat")
    want = np.asarray(jbase._policy_actions(jbase.get_env(env), None, n, "repeat"))
    np.testing.assert_array_equal(actions.numpy(), np.repeat(want[:, None], t_steps, axis=1))
    gen = torch.Generator().manual_seed(3)
    state = spec.reset(n, "cpu", gen)
    a = torch.from_numpy(want.astype(np.int64))
    for t in range(t_steps):
        state, r, d = spec.step(state, a, None)
        np.testing.assert_array_equal(obs[:, t].numpy(), spec.render(state).numpy())
        np.testing.assert_array_equal(rewards[:, t].numpy(), r.numpy())
        np.testing.assert_array_equal(dones[:, t].numpy(), d.numpy())
        fresh = spec.reset(n, "cpu", gen)   # the auto-reset's draw
        state = type(state)(*(torch.where(d.view((-1,) + (1,) * (s.ndim - 1)), f, s)
                              for s, f in zip(state, fresh)))
    if env == "realpong":
        assert dones.any()


def test_realpong_host_env_matches_jax_to_the_score():
    """A HostEnv started from JAX's HostEnv's first reset: the same frames,
    rewards and done flags up to and including the step that scores."""
    jenv = jbase.HostEnv(jbase.get_env("realpong"), seed=4)
    jobs = jenv.reset()
    spec = tbase.get_env("realpong")
    template = spec.reset(1, "cpu", torch.Generator().manual_seed(0))
    start = to_torch_state(template, jax.tree.map(lambda x: np.asarray(x)[None], jenv.state))
    tenv = tbase.HostEnv(spec, device="cpu", start_state=start)
    np.testing.assert_array_equal(tenv.reset(), jobs)
    for step in range(200):
        got, want = tenv.step(0), jenv.step(0)   # the right paddle climbs away
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
        if want[2]:
            break
    assert want[2] and want[1] != 0, "no score in 200 steps"


# ---------------------------------------------------------------------------
# the free-run evaluation on the 64x64 bundles
# ---------------------------------------------------------------------------

# The pixel curve through the bf16 decoder: the flagship file's 1% where
# the frames have content (minipong_cf).  boxes_cf's frames are mostly
# background, which it predicts at logits near -15, so its pixel MSE (1e-8
# to 1e-5) is a sum of sigmoid tails; a bf16 logit there is rounded by up to
# 2^-9 of itself (0.03), which moves a squared tail by up to 6%.  The mean
# over a frame moves by less, as the roundings differ in sign: 1.6% at most
# on this batch, held at 2.5%.
FREE_RUN = [("boxes_cf", "boxes", 2.5e-2), ("minipong_cf", "minipong", BF16_RTOL)]


@pytest.mark.parametrize("bundle,env,bf16_rtol", FREE_RUN)
def test_free_run_stats_match_jax(bundle, env, bf16_rtol):
    """B = 4 trajectories x 12 steps of the env's own (JAX's rollout): the
    curves per horizon through the port's f32 transition and decoder, and
    the pixel curve through the f32 transition and the port's default
    decoder (the kernel's plain bf16 version on the CPU), against JAX's
    ``_free_run_stats``, to the flagship file's tolerances."""
    model = load_model(os.path.join(REPO, "pretrained_models", bundle), device="cpu")
    jax_model = jwm.WorldModel(**{n: jax.tree.map(lambda t: t.numpy(), getattr(model, n))
                                  for n in jwm.WorldModel._fields})
    spec = jbase.get_env(env)
    batch = tuple(np.array(x) for x in jbase.rollout(spec, jax.random.PRNGKey(12), 4, 12))
    want = jmse._free_run_stats(jax_model, tuple(jnp.asarray(x) for x in batch),
                                spec.num_actions)
    tbatch = tuple(torch.from_numpy(x) for x in batch)
    transition = lambda z, a: twm.transition(model.transition, z, a)  # noqa: E731
    got = tmse._free_run_stats(model, tbatch, spec.num_actions, transition_fn=transition,
                               decode_fn=lambda z: twm.decode(model.decoder, z))
    names = ["pixel mse", "pixel std", "reward mse", "reward std", "active"]
    for name, w, g in zip(names, want, got):
        assert g.shape == (10,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    assert np.asarray(want[0]).min() > 0
    default = tmse._free_run_stats(model, tbatch, spec.num_actions, transition_fn=transition)
    np.testing.assert_allclose(default[0].numpy(), np.asarray(want[0]), rtol=bf16_rtol,
                               atol=PIXEL_BF16_ATOL)


def test_forward_simulation_video_on_a_grey_env(tmp_path):
    """boxes_cf renders one channel: the forward-simulation video's reward
    overlay makes the grey frame RGB (the JAX package's raises an
    IndexError there), the same as on the frame repeated to RGB."""
    from scmgan_tpu_torch.analysis import visualize
    from scmgan_tpu_torch.data.datasource import allocate_datasource

    rng = np.random.default_rng(6)
    grey = rng.random((64, 64, 1)).astype(np.float32)
    rmap = rng.uniform(-1, 1, (30, 30, 1)).astype(np.float32)
    np.testing.assert_array_equal(visualize.reward_overlay(grey, rmap),
                                  visualize.reward_overlay(np.repeat(grey, 3, axis=-1), rmap))
    model = load_model(os.path.join(REPO, "pretrained_models", "boxes_cf"), device="cpu")
    ds = allocate_datasource("boxes", device="cpu")
    path = visualize.visualize_forward_simulation(model, ds, timesteps=6, out_dir=str(tmp_path),
                                                  generator=torch.Generator().manual_seed(0))
    assert os.path.exists(path)
