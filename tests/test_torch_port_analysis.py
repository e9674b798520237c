"""The port's analysis slice (scmgan_tpu_torch.analysis.{visualize,
causal_graph,higgins}, the visualize forms of decode / predict_reward, the
envs' Higgins simulators, TimeSeries) against scmgan_tpu's on the CPU.

The rollouts run on the port's plain f32 route (the serving packers
patched to f32, so the kernels' CPU versions compute in f32) with the shipped gridworld_cf weights on 16x16 frames, so that both sides
compute the same function in f32: latents must be bit-equal except where a
transition's p lies within EPS_P of 0.5 somewhere up the chain (two f32
implementations sum in other orders), logits, reward vectors and maps
agree to 1e-5.  The simulators, the moment features and the z-diff sets
are exact; the Higgins classifier is held with JAX's minibatch indices
replayed.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.analysis import causal_graph as jcg
from scmgan_tpu.analysis import higgins as jhig
from scmgan_tpu.analysis import visualize as jvis
from scmgan_tpu.envs import get_env as jget_env
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.utils.timeseries import TimeSeries as JaxTimeSeries
from scmgan_tpu_torch.analysis import causal_graph as tcg
from scmgan_tpu_torch.analysis import mse as tmse
from scmgan_tpu_torch.analysis import higgins as thig
from scmgan_tpu_torch.analysis import visualize as tvis
from scmgan_tpu_torch.data.datasource import allocate_datasource
from scmgan_tpu_torch.envs import get_env as tget_env
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.ops.kernels.fused_transition import (
    pack_transition_weights,
    transition_probs,
)
from scmgan_tpu_torch.train import checkpoint as tckpt
from scmgan_tpu_torch.utils.timeseries import TimeSeries
from test_torch_port_train_step import _jax_params

REPO = os.path.join(os.path.dirname(__file__), "..")
GRID = os.path.join(REPO, "pretrained_models", "gridworld_cf")
A = 4
# A latent bit may differ between two f32 implementations only where the
# sigmoid's p is this close to 0.5 (a logit within 4e-6 of 0).
EPS_P = 1e-6
RTOL = ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    tp = tckpt.load_model(GRID, device="cpu")
    jp = jwm.WorldModel(**jax.tree.map(jnp.asarray, tckpt.params_to_numpy(tp)))
    return tp, jp


@pytest.fixture
def f32_route(monkeypatch):
    """The serving packers in f32: on the CPU the kernels' plain versions
    then compute what the JAX package computes."""
    for name in ("pack_transition_weights", "pack_decoder_weights"):
        monkeypatch.setattr(tmse, name, functools.partial(
            getattr(tmse, name), dtype=torch.float32))


def _trajectory(seed, t):
    ds = allocate_datasource("gridworld", seed=0, device="cpu")
    return ds.collect(1, t, generator=torch.Generator().manual_seed(seed))


def _margins(tp, z, actions_oh):
    """Run the chain z -> ... on the port's f32 transition; returns the
    latents after each step and, per sample, the smallest |p - 0.5| up to
    each step."""
    pt = pack_transition_weights(tp.transition, 16, A, dtype=torch.float32)
    zs, margins, m = [], [], torch.full((z.shape[0],), np.inf)
    for a in actions_oh:
        p = transition_probs(pt, z, a)
        m = torch.minimum(m, (p - 0.5).abs().amin(dim=(1, 2, 3)))
        z = (p > 0.5).to(z.dtype)
        zs.append(z)
        margins.append(m.clone())
    return zs, margins


def _onehot(a):
    return torch.nn.functional.one_hot(torch.as_tensor(a).long(), A).float()


def test_decode_and_predict_reward_visualize_match_jax():
    params = _jax_params(hidden=16)
    tparams = tckpt.params_from_numpy(params, device="cpu")
    z = (np.random.default_rng(3).random((2, 16, 16, 16)) > 0.5).astype(np.float32)
    out, layers = twm.decode(tparams.decoder, torch.from_numpy(z), visualize=True)
    j_out, j_layers = jwm.decode(params.decoder, jnp.asarray(z), visualize=True)
    assert layers.shape == j_layers.shape == (16, 16, 16, 3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(layers.detach().numpy(), np.asarray(j_layers),
                               rtol=RTOL, atol=ATOL)
    total, signed = twm.predict_reward(tparams.reward_predictor, torch.from_numpy(z),
                                       visualize=True)
    j_total, j_signed = jwm.predict_reward(params.reward_predictor, jnp.asarray(z),
                                           visualize=True)
    assert signed.shape == j_signed.shape
    np.testing.assert_allclose(total.detach().numpy(), np.asarray(j_total), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(signed.detach().numpy(), np.asarray(j_signed),
                               rtol=RTOL, atol=ATOL)


def test_simulation_rollout_matches_jax(models, f32_route):
    tp, jp = models
    obs, rewards, dones, actions = _trajectory(1, 14)
    got = tvis._simulation_rollout(tp, obs, actions, A)
    want = [np.asarray(x) for x in jvis._simulation_rollout(
        jp, jnp.asarray(obs.numpy()), jnp.asarray(actions.numpy()), A)]
    oh = _onehot(actions)
    z0 = twm.encode(tp.encoder, obs[:, :3])
    zs, margins = _margins(tp, z0, [oh[:, t] for t in range(1, 13)])
    # step i of the rollout decodes the latent after i + 1 transitions
    trusted = [i for i in range(len(want[0])) if float(margins[i][0]) >= EPS_P]
    print(f"simulation rollout: {len(trusted)} of {len(want[0])} steps before a near tie")
    assert len(trusted) >= len(want[0]) // 2
    for i in trusted:
        np.testing.assert_array_equal(got[3][i].numpy(), want[3][i])
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g[i].numpy(), w[i], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("offset", [1, 3])
def test_reconstruction_rollout_matches_jax(models, offset, f32_route):
    """Every window is one batch element of the port's call (B = T - 3 -
    offset)."""
    tp, jp = models
    t_total = 12
    obs, rewards, dones, actions = _trajectory(2, t_total)
    got = tvis._reconstruction_rollout(tp, obs, actions, A, offset)
    want = [np.asarray(x) for x in jvis._reconstruction_rollout(
        jp, jnp.asarray(obs.numpy()), jnp.asarray(actions.numpy()), A, offset)]
    ts = np.arange(3, t_total - offset)
    assert got[0].shape[0] == len(ts) == t_total - 3 - offset
    oh = _onehot(actions[0])
    frames = obs[0][torch.as_tensor(ts)[:, None] + torch.arange(-2, 1)]
    chain = [oh[ts - 1]] + [oh[ts + i] for i in range(offset)]
    _, margins = _margins(tp, twm.encode(tp.encoder, frames), chain)
    trusted = (margins[-1] >= EPS_P).numpy()
    print(f"reconstruction offset {offset}: {int(trusted.sum())} of {len(ts)} windows "
          f"clear of near ties")
    assert trusted.sum() >= len(ts) // 2
    np.testing.assert_array_equal(got[3].numpy()[trusted], want[3][trusted])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy()[trusted], w[trusted], rtol=RTOL, atol=ATOL)


def test_planning_rollout_matches_jax(models, f32_route):
    tp, jp = models
    obs, _, _, _ = _trajectory(3, 3)
    z = twm.transition(tp.transition, twm.encode(tp.encoder, obs), _onehot([3]),
                       train=False)
    actions = np.random.default_rng(4).integers(0, A, (4, 5))
    got = tvis._planning_rollout(tp, z, torch.from_numpy(actions), A, 5)
    want = [np.asarray(x) for x in jvis._planning_rollout(
        jp, jnp.asarray(z.detach().numpy()), jnp.asarray(actions), A, 5)]
    _, margins = _margins(tp, z.expand(4, -1, -1, -1),
                          [_onehot(actions[:, t]) for t in range(5)])
    assert float(margins[-1].min()) >= EPS_P
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_causal_edge_weights_match_jax(models):
    """Exact on the binary latents of sample_transition's batch: the maxima
    are 0 or 1; each mean sums 0/1 values and divides once."""
    tp, jp = models
    ds = allocate_datasource("gridworld", seed=0, device="cpu")
    src_z, onehot = tcg.sample_transition(tp, ds, batch_size=3,
                                          generator=torch.Generator().manual_seed(6))
    assert set(np.unique(src_z.numpy())) <= {0.0, 1.0}
    w, m = tcg._causal_edge_weights(tp, src_z, onehot)
    jw, jm = (np.asarray(x) for x in jcg._causal_edge_weights(
        jp, jnp.asarray(src_z.numpy()), jnp.asarray(onehot.numpy()), A))
    keep = 1.0 - torch.eye(16)
    perturbed = (src_z[None] * keep[:, None, None, None, :]).reshape(-1, 16, 16, 16)
    _, margins = _margins(tp, torch.cat([src_z, perturbed]),
                          [onehot.repeat(17, 1)])
    assert float(margins[0].min()) >= EPS_P
    np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-6, atol=0)
    assert w.max() > 0


@pytest.mark.parametrize("env", ["gridworld", "pong", "minipacman"])
def test_simulators_match_jax(env):
    js, ts = jget_env(env), tget_env(env)
    assert ts.true_latent_dim == js.true_latent_dim
    factors = np.random.default_rng(7).uniform(size=(24, js.true_latent_dim))
    factors[:4] = 0.0
    factors[4:8] = 1.0
    factors[8:12] = 0.5
    kw = {}
    if env == "pong":
        # the JAX package's random actions: keys split from PRNGKey(0)
        keys = jax.random.split(jax.random.PRNGKey(0), len(factors))
        kw["actions"] = np.array([
            [int(jax.random.randint(jax.random.split(k)[0], (), 0, 4))
             for k in jax.random.split(key, 3)] for key in keys])
    got, want = ts.simulator(factors, **kw), js.simulator(factors)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, np.asarray(want))


def test_moment_features_match_jax():
    z = np.random.default_rng(8).random((5, 16, 16, 16)).astype(np.float32)
    z[0] = 0.0
    np.testing.assert_array_equal(thig._moment_features(z), jhig._moment_features(z))


def _numpy_encoder():
    """The same host encoder for both packages: a fixed projection of the
    pixels onto 16 channels, so the z-diffs depend on the protocol alone."""
    proj = np.random.default_rng(9).standard_normal((3, 16)).astype(np.float32)
    return lambda images: np.asarray(images, np.float32) @ proj


@pytest.mark.parametrize("variant", ["flat", "conv", "spatial"])
def test_collect_z_diffs_match_jax(variant):
    enc = _numpy_encoder()
    kw = dict(conv=variant == "conv", spatial_moments=variant == "spatial")
    dim = 16 * 3 if variant == "spatial" else 16 if variant == "conv" else 16 * 16 * 16
    got = thig._collect_z_diffs(tget_env("gridworld").simulator, enc, 2, dim, 2, 8,
                                np.random.default_rng(10), **kw)
    want = jhig._collect_z_diffs(jget_env("gridworld").simulator, enc, 2, dim, 2, 8,
                                 np.random.default_rng(10), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _jax_indices(seed):
    key = jax.random.PRNGKey(seed)
    return lambda i, batch, n: np.asarray(
        jax.random.randint(jax.random.fold_in(key, i), (batch,), 0, n))


@pytest.mark.parametrize("spatial", [False, True])
def test_higgins_metric_matches_jax(spatial):
    """The classifier on the same z-diffs and JAX's minibatch indices: its
    weights to 1e-5 (two Adams in f32), the same accuracy end to end."""
    enc = _numpy_encoder()
    jsim, tsim = jget_env("gridworld").simulator, tget_env("gridworld").simulator
    z, y = jhig._collect_z_diffs(jsim, enc, 2, 16, 4, 16, np.random.default_rng(0), True)
    z = z / (z.std() + 1e-8)
    w, b = thig._train_classifier(z, y, 2, 30, _jax_indices(0))
    jw, jb = jhig._train_classifier(jnp.asarray(z), jnp.asarray(y), 2, 30,
                                    jax.random.PRNGKey(0))
    np.testing.assert_allclose(w, np.asarray(jw), rtol=0, atol=1e-5)
    np.testing.assert_allclose(b, np.asarray(jb), rtol=0, atol=1e-5)
    fn = jhig.higgins_metric_spatial if spatial else jhig.higgins_metric_conv
    tfn = thig.higgins_metric_spatial if spatial else thig.higgins_metric_conv
    want = fn(jsim, 2, enc, 16, train_iters=40, seed=3)
    got = tfn(tsim, 2, enc, 16, train_iters=40, seed=3, indices=_jax_indices(3))
    assert got == want


def test_make_encoder_fn_matches_jax():
    params = _jax_params(hidden=16)
    tparams = tckpt.params_from_numpy(params, device="cpu")
    frames = np.random.default_rng(11).random((3, 16, 16, 3)).astype(np.float32)
    got = thig.make_encoder_fn(tparams.encoder)(frames)
    want = np.asarray(jhig.make_encoder_fn(params.encoder)(frames))
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_timeseries_matches_jax(tmp_path):
    ours = TimeSeries("t", 20, tensorboard=True, logdir=str(tmp_path / "a"))
    theirs = JaxTimeSeries("t", 20, tensorboard=True, logdir=str(tmp_path / "b"))
    for i in range(12):
        for ts in (ours, theirs):
            ts.collect_dict({"loss": 1.0 / (i + 1), "reward": torch.tensor(float(i))
                             if ts is ours else float(i)})
            ts.print_every(5)
    assert ours.series == theirs.series and ours.iteration == theirs.iteration == 12
    assert ours.summary().splitlines()[1:] == theirs.summary().splitlines()[1:]
    ours.close()
    theirs.close()
