"""The port's MPC planner (scmgan_tpu_torch.agent.mpc) against
scmgan_tpu.agent.mpc on the CPU, on the trained gridworld_cf weights from an
encoded window of a real episode (and one pong_cf case at 64x64).

The port's planner runs here on the plain f32 transition (the JAX package's
arithmetic); ``JaxPlanNoise`` replays the JAX function's keys: the random
tail's table from ``key``, and for ``rollout_samples`` > 1 the uniforms of
each sampled tail step from ``fold_in(key, 0x5A)`` split once a step.  The
int8 cases hand both sides the JAX package's quantized weights, and every
int8 step the port's beam takes is held bit for bit against
``transition_int8_v2`` of the JAX package.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.agent import mpc as jmpc
from scmgan_tpu.envs import base as jbase
from scmgan_tpu.models import quantized as jq
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu_torch.agent import mpc as tmpc
from scmgan_tpu_torch.models import quantized as tq
from scmgan_tpu_torch.ops.kernels.fused_transition import (
    pack_transition_weights,
    transition_plain,
)
from scmgan_tpu_torch.train.checkpoint import load_model

REPO = os.path.join(os.path.dirname(__file__), "..")
A, DEPTH = 4, 3
# Scores: f32 on both sides, convs and the reward map's pixel sum taken in
# another order (about 1e-6 relative per op), over a few steps of summed
# rewards of magnitude up to about 30.
SCORE_RTOL = SCORE_ATOL = 1e-5
# Calibrated scales: the exact f32 forwards of the two frameworks differ by
# a few ulps, so the per-channel maxima agree to 1e-5 relative
# (test_torch_port_quantized.py's SCALE_RTOL).
SCALE_RTOL = 1e-5


def jax_model_of(model):
    return jwm.WorldModel(**{n: jax.tree.map(lambda t: t.numpy(), getattr(model, n))
                             for n in jwm.WorldModel._fields})


def seed_latent(jax_model, env, seed):
    """The planner's input as play makes it: three frames of an episode,
    encoded, then one eval-mode transition under the no-op."""
    obs = jbase.rollout(jbase.get_env(env), jax.random.PRNGKey(seed), 1, 3)[0]
    z = jwm.encode(jax_model.encoder, obs)
    z = jwm.transition(jax_model.transition, z, jax.nn.one_hot(jnp.int32([3]), A),
                       train=False)
    return np.array(z)


@pytest.fixture(scope="module")
def gridworld():
    model = load_model(os.path.join(REPO, "pretrained_models", "gridworld_cf"),
                       device="cpu")
    jax_model = jax_model_of(model)
    return model, jax_model, seed_latent(jax_model, "gridworld", 5)


class JaxPlanNoise(tmpc.PlanNoise):
    """``PlanNoise`` replaying ``scmgan_tpu.agent.mpc``'s keys: the random
    tail ``randint(key, (width, depth - lookahead))`` (mpc.py:46); the
    sampled tail's steps ``k, sub = split(k)`` from ``fold_in(key, 0x5A)``
    (mpc.py:171,187), whose Bernoulli draws are ``uniform(sub, p.shape) <
    p``.  Its seeds are the step numbers, which ``uniform`` maps back."""

    def __init__(self, key, lookahead, depth=DEPTH):
        super().__init__(torch.Generator())
        self.key, self.lookahead, self.depth = key, lookahead, depth
        k = jax.random.fold_in(key, 0x5A)
        self.step_keys = []
        for _ in range(depth - lookahead):
            k, sub = jax.random.split(k)
            self.step_keys.append(sub)

    def tail_actions(self, shape, num_actions):
        width = num_actions ** (self.lookahead + 1)
        tail = jax.random.randint(self.key, (width, self.depth - self.lookahead), 0,
                                  num_actions)
        assert tuple(shape) == (1, width, self.depth - self.lookahead)
        return torch.from_numpy(np.array(tail, dtype=np.int64))[None]

    def sample_seeds(self, n):
        assert n == len(self.step_keys)
        return list(range(n))

    def uniform(self, seed, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(self.step_keys[seed], tuple(shape), jnp.float32)))


def f32_steps(model, noise=None, qt=None):
    """``plan_steps`` in f32, with the sampled step drawing ``noise``'s
    replayed uniforms; the int8 step records every call."""
    steps = tmpc.plan_steps(model, A, dtype=torch.float32, qt=qt)
    packed = pack_transition_weights(model.transition, 16, A, dtype=torch.float32)
    calls = []

    def sample(z, a, seed):
        return transition_plain(packed, z, a, u=noise.uniform(seed, z.shape))

    def int8(z, a):
        out = steps.int8(z, a)
        calls.append((z.clone(), a.clone(), out.clone()))
        return out

    return steps._replace(sample=sample, int8=int8 if qt is not None else None), calls


def assert_scores_match(got, want):
    """Scores to the stated tolerance; the argmax wherever the top two
    scores are further apart than it."""
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
    top = np.sort(want)[-2:]
    if top[1] - top[0] > SCORE_ATOL + SCORE_RTOL * abs(top[1]):
        assert int(np.argmax(got)) == int(np.argmax(want))


@pytest.mark.parametrize("num_actions,lookahead,depth", [
    (a, la, la + extra) for a in (2, 4, 5) for la in (0, 1, 2) for extra in (0, 2)])
def test_action_table_matches_jax(num_actions, lookahead, depth):
    key = jax.random.PRNGKey(depth * 7 + lookahead)
    for policy in ("noop", "greedy"):
        np.testing.assert_array_equal(
            tmpc._action_table(num_actions, lookahead, depth, policy).numpy(),
            np.asarray(jmpc._action_table(num_actions, lookahead, depth, policy, None)))
    want = np.asarray(jmpc._action_table(num_actions, lookahead, depth, "random", key))
    tail = torch.from_numpy(want[:, lookahead + 1:].astype(np.int64))
    np.testing.assert_array_equal(
        tmpc._action_table(num_actions, lookahead, depth, "random", tail).numpy(), want)


CASES = {
    "noop_l2": dict(lookahead=2),
    "noop_l2_unshared": dict(lookahead=2, share_prefix=False),
    "caution_l1": dict(lookahead=1, negative_positive_tradeoff=0.1),
    "random_l2": dict(lookahead=2, rollout_policy="random"),
    "greedy_l1": dict(lookahead=1, rollout_policy="greedy"),
    "greedy_l2_unshared": dict(lookahead=2, rollout_policy="greedy", share_prefix=False),
    "samples2_random_l1": dict(lookahead=1, rollout_samples=2, rollout_policy="random"),
    "samples2_greedy_l1": dict(lookahead=1, rollout_samples=2, rollout_policy="greedy"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_reward_table_matches_jax(gridworld, case):
    model, jax_model, z = gridworld
    kw = CASES[case]
    key = jax.random.PRNGKey(17)
    want = jmpc.rollout_reward_table(jax_model, jnp.asarray(z), A, rollout_depth=DEPTH,
                                     key=key, **kw)
    noise = JaxPlanNoise(key, kw["lookahead"])
    steps, _ = f32_steps(model, noise)
    got = tmpc.rollout_reward_table(model, torch.from_numpy(z), A, rollout_depth=DEPTH,
                                    noise=noise, steps=steps, **kw)
    assert got.shape == (1, A)
    assert_scores_match(got[0], want)


@pytest.fixture(scope="module")
def quantized(gridworld):
    """The JAX package's static and calibrated quantizations of the
    transition, each beside the port's QuantizedTransition of the same
    weights."""
    _, jax_model, z = gridworld
    out = {"static": jq.quantize_transition(jax_model.transition),
           "calibrated": jmpc.calibrated_qt(jax_model, jnp.asarray(z), A,
                                            key=jax.random.PRNGKey(3), steps=1 + INT8_DEPTH)}
    return {k: (jqt, tq.make_quantized(*(
        {n: torch.from_numpy(np.array(v)) for n, v in d.items()}
        for d in (jqt.weights, jqt.scales, jqt.biases, jqt.requant))))
        for k, jqt in out.items()}


INT8_DEPTH = 2


@pytest.mark.parametrize("quant,kw", [
    ("static", dict(use_int8=True)),
    ("calibrated", dict(use_int8=True)),
    ("calibrated", dict(int8_tail=True)),
], ids=["static_int8", "calibrated_int8", "calibrated_int8_tail"])
def test_int8_beam_matches_jax(gridworld, quantized, quant, kw):
    """Both sides on the JAX package's quantized weights (lookahead 1, depth
    2): every int8 step of the port's beam bit-equal to
    ``transition_int8_v2``, scores to the stated tolerance."""
    model, jax_model, z = gridworld
    jqt, qt = quantized[quant]
    want = jmpc.rollout_reward_table(jax_model, jnp.asarray(z), A, lookahead=1,
                                     rollout_depth=INT8_DEPTH, qt=jqt, **kw)
    steps, calls = f32_steps(model, qt=qt)
    got = tmpc.rollout_reward_table(model, torch.from_numpy(z), A, lookahead=1,
                                    rollout_depth=INT8_DEPTH, steps=steps, **kw)
    assert len(calls) == (INT8_DEPTH - 1) + (0 if kw.get("int8_tail") else 2)
    # the samples of a step are independent: one JAX call checks every step
    z_in, a, z_out = (torch.cat(x).numpy() for x in zip(*calls))
    np.testing.assert_array_equal(z_out, np.asarray(jax.jit(jq.transition_int8_v2)(
        jqt, jnp.asarray(z_in), jnp.asarray(a))))
    assert_scores_match(got[0], want)


class CalibrationNoise(tmpc.PlanNoise):
    """``calibrated_qt``'s actions as ``randint(key, (samples, steps))``
    draws them (mpc.py:266)."""

    def __init__(self, key):
        super().__init__(torch.Generator())
        self.key = key

    def calibration_actions(self, shape, num_actions):
        return torch.from_numpy(np.array(jax.random.randint(
            self.key, tuple(shape), 0, num_actions), dtype=np.int64))


def test_calibrated_qt_matches_jax(gridworld):
    """The calibration batch (z repeated, JAX's random actions) gives the
    JAX package's activation scales; the int8 codes are those of the same
    folded weights (the spectral norm's last bit aside, see
    test_torch_port_quantized.py)."""
    model, jax_model, z = gridworld
    key = jax.random.PRNGKey(3)
    want = jmpc.calibrated_qt(jax_model, jnp.asarray(z), A, key=key, n_samples=4, steps=5)
    got = tmpc.calibrated_qt(model, torch.from_numpy(z), A, noise=CalibrationNoise(key),
                             n_samples=4, steps=5)
    for name in want.requant:
        np.testing.assert_allclose(got.requant[name].numpy(), np.asarray(want.requant[name]),
                                   rtol=SCALE_RTOL, err_msg=name)
        codes = got.weights[name].numpy().astype(np.int32)
        differ = codes != np.asarray(want.weights[name])
        assert differ.mean() < 1e-3, name
        assert np.abs(codes - np.asarray(want.weights[name]))[differ].max(initial=0) <= 1


def test_pong_rollout_reward_table_matches_jax():
    """pong_cf at 64x64, lookahead 1, depth 2."""
    model = load_model(os.path.join(REPO, "pretrained_models", "pong_cf"), device="cpu")
    jax_model = jax_model_of(model)
    z = seed_latent(jax_model, "pong", 8)
    want = jmpc.rollout_reward_table(jax_model, jnp.asarray(z), A, lookahead=1,
                                     rollout_depth=2)
    steps, _ = f32_steps(model)
    got = tmpc.rollout_reward_table(model, torch.from_numpy(z), A, lookahead=1,
                                    rollout_depth=2, steps=steps)
    assert_scores_match(got[0], want)


def test_batched_episodes_and_planner(gridworld):
    """E latent states in one beam give each one's own scores; make_planner
    packs once and returns the first maximum."""
    model, jax_model, z = gridworld
    z2 = np.concatenate([z, seed_latent(jax_model, "gridworld", 6)])
    steps, _ = f32_steps(model)
    both = tmpc.rollout_reward_table(model, torch.from_numpy(z2), A, lookahead=1,
                                     rollout_depth=DEPTH, steps=steps)
    for e in range(2):
        one = tmpc.rollout_reward_table(model, torch.from_numpy(z2[e:e + 1]), A,
                                        lookahead=1, rollout_depth=DEPTH, steps=steps)
        np.testing.assert_allclose(both[e].numpy(), one[0].numpy(), rtol=1e-6, atol=1e-6)
    plan = tmpc.make_planner(model, A, lookahead=1, rollout_depth=DEPTH,
                             dtype=torch.float32)
    action, scores = plan(torch.from_numpy(z))
    np.testing.assert_allclose(scores.numpy(), both[0].numpy(), rtol=1e-6, atol=1e-6)
    assert action == int(np.argmax(scores.numpy()))


def test_rollout_reward_table_rejects_bad_options(gridworld):
    model, _, z = gridworld
    zt = torch.from_numpy(z)
    noise = tmpc.PlanNoise(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="exact stochastic"):
        tmpc.rollout_reward_table(model, zt, A, 1, DEPTH, use_int8=True,
                                  rollout_samples=2, noise=noise)
    with pytest.raises(ValueError, match="need a PlanNoise"):
        tmpc.rollout_reward_table(model, zt, A, 1, DEPTH, rollout_policy="random")
    with pytest.raises(ValueError, match="unknown rollout policy"):
        tmpc.rollout_reward_table(model, zt, A, 1, DEPTH, rollout_policy="thrash")
