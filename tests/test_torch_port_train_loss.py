"""The port's ``world_model_loss`` against scmgan_tpu's, option by option,
on the CPU: the same JAX-initialised weights (hidden 16), the same numpy
batch (16x16 frames, B = 3, horizon 6) and, through ``JaxKeyNoise``, the
same random numbers as JAX's key schedule draws.

For each option: the loss and every metric, every gradient leaf
(``jax.grad`` against ``.backward()``), and every sampled latent bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.models.world_model import init_world_model
from scmgan_tpu.train import losses as jl
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.train import losses as tl
from scmgan_tpu_torch.train.checkpoint import params_from_numpy
from scmgan_tpu_torch.train.trainer import trainable_leaves

B, HORIZON, HW, HIDDEN = 3, 6, 16, 16
THETA = 0.4
# f32: the two frameworks sum convs and means in other orders (a few ulps
# per op), so the loss and metrics agree to 1e-5 relative.
LOSS_RTOL = 1e-5
# Gradients: relative 1e-4, plus an absolute floor of 1e-5 of the leaf's
# largest entry for entries that are sums of cancelling terms.
GRAD_RTOL = 1e-4
GRAD_ATOL_OF_MAX = 1e-5
# A sampled bit may differ only where the uniform lies this close to p.
U_EDGE = 1e-6
# bf16 (one case): each conv's output is rounded to 8 mantissa bits after
# sums in another order (one bf16 ulp is 0.4%), and a sampled bit flips
# where |u - p| is within such an ulp; the losses are means over thousands
# of such elements, so they agree to 1%, each network's gradient norm to 5%.
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_NORM_RTOL = 5e-2


class JaxKeyNoise(tl.LossNoise):
    """``LossNoise`` replaying ``scmgan_tpu.train.losses``'s key schedule:
    ``key, scan_key = split(key)``, ``split(scan_key, n_steps)`` and
    ``k_trans, k_enc, k_lo = split(k_t, 3)`` per step (losses.py:162,226);
    each CF term ``key, k, k_roll = split(key, 3)`` (:325, :343), then
    ``k_roll, k_t = split(k_roll)`` per roll-out step (:328).
    ``jax.random.bernoulli(k, p)`` is ``uniform(k, p.shape, p.dtype) < p``,
    so the uniforms come in p's dtype."""

    def __init__(self, key, horizon):
        self.key, scan_key = jax.random.split(key)
        self.step_keys = jax.random.split(scan_key, horizon - 2)
        self.k_roll = None

    @staticmethod
    def _uniform(k, shape, dtype):
        jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        u = jax.random.uniform(k, tuple(shape), jdtype).astype(jnp.float32)
        return torch.from_numpy(np.array(u)).to(dtype)

    def transition(self, t, shape, dtype):
        return self._uniform(jax.random.split(self.step_keys[t - 1], 3)[0], shape, dtype)

    def overshoot(self, t, shape, dtype):
        return self._uniform(jax.random.split(self.step_keys[t - 1], 3)[2], shape, dtype)

    def swap_indices(self, b, latent_dim):
        self.key, k_swap, self.k_roll = jax.random.split(self.key, 3)
        return tuple(torch.from_numpy(np.array(
            jax.random.randint(k, (b,), 0, latent_dim)).astype(np.int64))
            for k in jax.random.split(k_swap))

    def permutation(self, b):
        self.key, k_perm, self.k_roll = jax.random.split(self.key, 3)
        return torch.from_numpy(np.array(jax.random.permutation(k_perm, b)).astype(np.int64))

    def rollout(self, shape, dtype):
        self.k_roll, k_t = jax.random.split(self.k_roll)
        return self._uniform(k_t, shape, dtype)


CASES = {
    "plain": ({}, False, 1.0),
    "done_mask": ({}, True, 1.0),
    "truncate_bptt": ({"truncate_bptt": True}, True, 1.0),
    "l1_terms": ({"activation_l1_coef": 1e-2, "transition_l1_coef": 1e-2}, True, 1.0),
    "deterministic": ({"deterministic_transition": True}, True, 1.0),
    "cf_inactive": ({"enable_cf_shuffle": True, "enable_cf_control": True,
                     "counterfactual_horizon": 2}, True, 0.0),
    "remat_transition": ({"remat_transition": True}, True, 1.0),
}
# the slot buffer and the CF roll-outs: test_torch_port_train_loss_cf.py
CASES_CF = {
    "latent_overshooting": ({"latent_overshooting": True}, True, 1.0),
    "latent_td": ({"latent_td": True}, True, 1.0),
    "cf_swap": ({"enable_cf_shuffle": True, "counterfactual_horizon": 3}, True, 1.0),
    "cf_control": ({"enable_cf_control": True, "counterfactual_horizon": 3}, True, 1.0),
}


@pytest.fixture(scope="module")
def setup():
    params = jax.tree.map(np.asarray, init_world_model(
        jax.random.PRNGKey(1), 16, 5, 2, 3, 3, hidden=HIDDEN, img_size=HW))
    rng = np.random.default_rng(0)
    obs = (rng.random((B, HORIZON, HW, HW, 3)) > 0.7).astype(np.float32)
    rewards = rng.integers(-1, 2, (B, HORIZON, 2)).astype(np.float32)
    dones = np.zeros((B, HORIZON), bool)
    dones[1, 3] = True            # one episode ends mid-trajectory
    actions = rng.integers(0, 5, (B, HORIZON))
    return params, (obs, rewards, dones, actions)


def _port_params(params):
    tp = params_from_numpy(params, device="cpu")
    for name in tp._fields:
        for leaf in trainable_leaves(getattr(tp, name)):
            leaf.requires_grad_(True)
    return tp


def _port_loss(params, batch, key, cf_active, opts, dtype=torch.float32):
    tp = _port_params(params)
    obs, rewards, dones, actions = (torch.from_numpy(np.asarray(x)) for x in batch)
    lcfg = tl.LossConfig(horizon=HORIZON, **opts)
    loss, metrics = tl.world_model_loss(
        tp, (obs.to(dtype), rewards, dones, actions), JaxKeyNoise(key, HORIZON),
        THETA, cf_active, lcfg)
    loss.backward()
    return tp, {k: float(v.detach()) for k, v in metrics.items()}


def _jax_loss(params, batch, key, cf_active, opts, dtype=jnp.float32):
    obs, rewards, dones, actions = batch
    lcfg = jl.LossConfig(horizon=HORIZON, **opts)
    fn = jax.jit(jax.value_and_grad(jl.world_model_loss, has_aux=True),
                 static_argnums=5)
    (_, metrics), grads = fn(jax.tree.map(jnp.asarray, params),
                             (jnp.asarray(obs, dtype), rewards, dones, actions),
                             key, jnp.float32(THETA), jnp.float32(cf_active), lcfg)
    return grads, {k: float(v) for k, v in metrics.items()}


def _grad_pairs(jax_grads, port_params):
    """(path, JAX gradient, port gradient or None) for every leaf."""
    for name in port_params._fields:
        for path, g in jax.tree_util.tree_leaves_with_path(getattr(jax_grads, name)):
            node = getattr(port_params, name)
            for p in path:
                node = node[p.key]
            yield f"{name}/{jax.tree_util.keystr(path)}", np.asarray(g), node.grad


def _jax_sampled_bits(params, batch, key, cf_active, opts, monkeypatch):
    """(p, sample) of every straight-through draw of JAX's loss forward, in
    call order: ``st_bernoulli`` reports them through an ordered debug
    callback, with ``jax.checkpoint`` as the identity (its recomputation
    would report them twice; it changes no value)."""
    calls = []
    original = jwm.st_bernoulli

    def recording(k, p):
        jax.debug.callback(
            lambda p, s: calls.append((np.asarray(p, np.float32), np.asarray(s))),
            p, jax.random.bernoulli(k, p), ordered=True)
        return original(k, p)

    obs, rewards, dones, actions = batch
    with monkeypatch.context() as m:
        m.setattr(jwm, "st_bernoulli", recording)
        m.setattr(jax, "checkpoint", lambda f, **kw: f)
        lcfg = jl.LossConfig(horizon=HORIZON, **opts)
        # a fresh function, so that no earlier trace (whose callback fills
        # another list) is reused
        fn = jax.jit(lambda *args: jl.world_model_loss(*args, lcfg))
        jax.block_until_ready(fn(
            jax.tree.map(jnp.asarray, params), (jnp.asarray(obs), rewards, dones, actions),
            key, jnp.float32(THETA), jnp.float32(cf_active)))
    jax.effects_barrier()
    return calls


def check_case(setup, opts, with_dones, cf_active, monkeypatch):
    """Loss, metrics, every gradient leaf and every sampled bit of one
    option set against JAX's."""
    params, batch = setup
    if not with_dones:
        batch = (batch[0], batch[1], np.zeros_like(batch[2]), batch[3])
    key = jax.random.PRNGKey(7)

    port_calls = []
    original = twm.st_bernoulli

    def recording(u, p):
        port_calls.append((u.numpy().copy(), p.detach().numpy().copy()))
        return original(u, p)

    monkeypatch.setattr(twm, "st_bernoulli", recording)
    tp, got = _port_loss(params, batch, key, cf_active, opts)
    monkeypatch.undo()
    grads, want = _jax_loss(params, batch, key, cf_active, opts)

    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    if cf_active == 0.0:   # the CF terms are computed but not added
        assert want["loss"] == pytest.approx(want["reconstruction_loss"]
                                             + THETA * 1e-3 * want["reward_loss"],
                                             rel=LOSS_RTOL)
    for path, gj, gt in _grad_pairs(grads, tp):
        if gt is None:   # u/v and the discriminator: no gradient in the port
            np.testing.assert_array_equal(gj, 0.0, err_msg=path)
            continue
        np.testing.assert_allclose(gt.numpy(), gj, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_OF_MAX * np.abs(gj).max(),
                                   err_msg=path)

    jax_calls = _jax_sampled_bits(params, batch, key, cf_active, opts, monkeypatch)
    assert len(port_calls) == len(jax_calls)
    if opts.get("deterministic_transition"):
        assert not port_calls
    n_bits = 0
    for (u, p), (p_jax, s_jax) in zip(port_calls, jax_calls):
        # the replayed uniforms are JAX's own: JAX's bits are u < p_jax
        np.testing.assert_array_equal(u < p_jax, s_jax)
        differ = (u < p) != s_jax
        assert np.all(np.abs(u - p_jax)[differ] < U_EDGE)
        n_bits += u.size
    assert n_bits > 0 or opts.get("deterministic_transition")


@pytest.mark.parametrize("case", list(CASES))
def test_loss_grads_and_bits_match_jax(setup, case, monkeypatch):
    check_case(setup, *CASES[case], monkeypatch)


def test_loss_bf16_matches_jax(setup):
    """The compute-dtype path: obs in bf16 on both sides, uniforms drawn in
    bf16 as JAX's bernoulli draws them."""
    params, batch = setup
    key = jax.random.PRNGKey(3)
    tp, got = _port_loss(params, batch, key, 1.0, {}, dtype=torch.bfloat16)
    grads, want = _jax_loss(params, batch, key, 1.0, {}, dtype=jnp.bfloat16)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=BF16_LOSS_RTOL, err_msg=k)
    for name in tp._fields[:4]:
        gj = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float64)))
                         for g in jax.tree.leaves(getattr(grads, name))))
        gt = np.sqrt(sum(float(torch.sum(leaf.grad.double() ** 2))
                         for leaf in trainable_leaves(getattr(tp, name))))
        np.testing.assert_allclose(gt, gj, rtol=BF16_GRAD_NORM_RTOL, err_msg=name)


def test_swap_two_factors_matches_jax():
    rng = np.random.default_rng(5)
    z = rng.random((4, 3, 3, 16)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want_z, want_map = jl._swap_two_factors(key, jnp.asarray(z), 16)
    noise = JaxKeyNoise(jax.random.PRNGKey(0), 3)
    ka, kb = jax.random.split(key)
    noise.swap_indices = lambda b, n: tuple(
        torch.from_numpy(np.array(jax.random.randint(k, (b,), 0, n)).astype(np.int64))
        for k in (ka, kb))
    got_z, got_map = tl._swap_two_factors(noise, torch.from_numpy(z), 16)
    np.testing.assert_array_equal(got_z.numpy(), np.asarray(want_z))
    np.testing.assert_array_equal(got_map.numpy(), np.asarray(want_map))


def test_bce_and_latent_loss_match_jax():
    rng = np.random.default_rng(6)
    logits = (rng.normal(size=(2, 4, 4, 3)) * 4).astype(np.float32)
    targets = (rng.random((2, 4, 4, 3)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tl.decoder_pixel_loss(torch.from_numpy(logits), torch.from_numpy(targets)).numpy(),
        np.asarray(jl.decoder_pixel_loss(logits, targets)), rtol=1e-6)
    a, b = rng.random((2, 2, 4, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tl.latent_state_loss(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jl.latent_state_loss(a, b)), rtol=1e-6)
