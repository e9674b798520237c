"""Model-predictive-control planner.

Port of ``scmgan_tpu/agent/mpc.py``.  The reference plans by looping in
Python over candidate first actions, each spawning a beam of
num_actions^lookahead futures rolled out ``rollout_depth`` steps under a
noop/random policy, and takes the max cumulative reward per first action with
reward channel 0 weighted by the tradeoff (reference main.py:354-363 and
compute_rollout_reward, main.py:455-489).

Here the whole search is one batch: all A^(lookahead+1) futures of every
latent state handed in (E episodes at once) step together, so each step of
the beam is one launch of the transition kernel with the beam as its batch:
the bf16 kernel (``ops/kernels/fused_transition.py``, threshold head for the
exact beam, Bernoulli head for ``rollout_samples`` > 1) or the int8 kernel
(``models/quantized.py::transition_int8_v2``).  ``predict_reward`` stays a
plain f32 conv, as the JAX package computes it outside any Pallas kernel,
with TF32 off: scores sum per-pixel rewards.

The beam's layout is the JAX package's: the prefix-shared head a0-major
(``repeat`` then ``tile``), the K sampled replicas replica-major, the greedy
tail's A successors of each beam state adjacent.  With E > 1 the episodes
are the outermost axis.  The randomness (the random tail's actions, the
sampled steps' Philox seeds, ``calibrated_qt``'s actions) comes from a
``PlanNoise``; a test hands in one that replays the JAX package's keys.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from scmgan_tpu_torch.models.quantized import (
    calibrate_transition,
    quantize_transition,
    transition_int8_v2,
)
from scmgan_tpu_torch.models.world_model import WorldModel, predict_reward
from scmgan_tpu_torch.ops.kernels.fused_transition import (
    fused_transition,
    pack_transition_weights,
    philox_uniform,
    transition_plain,
)
from scmgan_tpu_torch.utils.device import no_tf32

POLICIES = ("noop", "random", "greedy")


class PlanNoise:
    """Every random draw of a plan, from ``generator`` on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _randint(self, high: int, shape) -> torch.Tensor:
        g = self.generator
        return torch.randint(0, high, shape, generator=g, device=g.device)

    def tail_actions(self, shape, num_actions: int) -> torch.Tensor:
        """The random tail policy's actions, (..., width, tail length)."""
        return self._randint(num_actions, shape)

    def sample_seeds(self, n: int) -> list:
        """The Philox seeds of a plan's ``n`` sampled tail steps."""
        return self._randint(2 ** 31 - 1, (n,)).tolist()

    def calibration_actions(self, shape, num_actions: int) -> torch.Tensor:
        """``calibrated_qt``'s random actions, (samples, steps)."""
        return self._randint(num_actions, shape)


class PlanSteps(NamedTuple):
    """The transition steps a plan runs, on weights packed once.  Each takes
    latents (B, H, W, L) and one-hot actions (B, A) and returns latents in
    z's dtype."""

    exact: Callable           # (z, a) -> z, threshold head
    sample: Callable          # (z, a, seed) -> z, Bernoulli head
    int8: Optional[Callable]  # (z, a) -> z on the int8 kernel, or None


def int8_step(qt) -> Callable:
    """The int8 transition on ``qt`` (threshold head)."""
    return lambda z, a: transition_int8_v2(qt, z, a)


def plan_steps(params: WorldModel, num_actions: int, *, dtype=torch.bfloat16,
               qt=None) -> PlanSteps:
    """Pack the transition once for a planner.  ``dtype`` bf16: the card's
    kernel (``fused_transition``; on the CPU its plain bf16 version).
    ``dtype`` f32: the kernel's plain f32 version on any device, the JAX
    package's arithmetic.  ``qt``: a ``QuantizedTransition`` for the int8
    steps, or None."""
    latent = params.transition["conv6"]["w"].shape[-1]
    packed = pack_transition_weights(params.transition, latent, num_actions,
                                     dtype=dtype)
    if dtype == torch.bfloat16:
        exact = lambda z, a: fused_transition(packed, z, a)  # noqa: E731
        sample = lambda z, a, seed: fused_transition(packed, z, a, sample=True,  # noqa: E731
                                                     seed=seed)
    elif dtype == torch.float32:
        def exact(z, a):
            return transition_plain(packed, z, a)

        def sample(z, a, seed):
            u = philox_uniform(seed, (*z.shape[:3], packed["latent_pad"]))
            return transition_plain(packed, z, a, u=torch.from_numpy(u).to(z.device))
    else:
        raise ValueError(f"dtype must be bfloat16 or float32, not {dtype}")
    return PlanSteps(exact, sample, None if qt is None else int8_step(qt))


def best_action(scores: torch.Tensor) -> torch.Tensor:
    """(E, A) scores -> (E,) actions: the first maximum, as ``jnp.argmax``."""
    return scores.argmax(dim=-1)


def _action_table(num_actions: int, lookahead: int, rollout_depth: int,
                  rollout_policy: str, tail: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """(width, rollout_depth + 1) int64 action plans, width =
    A^(lookahead+1): the first action and an exhaustive lookahead block
    (row-major over the prefix), then the tail policy's actions: 0 for
    ``noop`` (reference main.py:467-471) and ``greedy`` (whose tail is chosen
    while it runs), ``tail`` for ``random``, shaped (..., width,
    rollout_depth - lookahead); the table then takes its leading axes."""
    width = num_actions ** (lookahead + 1)
    grids = torch.meshgrid(*[torch.arange(num_actions)] * (lookahead + 1),
                           indexing="ij")
    table = torch.zeros((width, rollout_depth + 1), dtype=torch.int64)
    table[:, :lookahead + 1] = torch.stack(grids, dim=-1).reshape(width, lookahead + 1)
    if rollout_policy != "random":
        return table
    if tail is None:
        raise ValueError("the random tail policy needs its actions")
    table = table.to(tail.device).expand(*tail.shape[:-1], -1).clone()
    table[..., lookahead + 1:] = tail
    return table


def rollout_reward_table(
    params: WorldModel,
    z: torch.Tensor,
    num_actions: int,
    lookahead: int = 2,
    rollout_depth: int = 12,
    rollout_policy: str = "noop",
    negative_positive_tradeoff: float = 10.0,
    noise: Optional[PlanNoise] = None,
    use_int8: bool = False,
    int8_tail: bool = False,
    qt=None,
    share_prefix: bool = True,
    rollout_samples: int = 1,
    steps: Optional[PlanSteps] = None,
) -> torch.Tensor:
    """Expected best cumulative reward per first action.

    z: (E, H, W, L) latent states, one per episode.  Returns (E, A) scores:
    score[e, a] = max over a's beam of the tradeoff-weighted cumulative
    predicted reward (compute_rollout_reward, main.py:455-489).

    ``rollout_policy``: the tail after the enumerated head: ``noop``
    (action 0), ``random`` (from ``noise``) or ``greedy`` (each tail step
    tries all A actions of every beam state and follows the best weighted
    step reward).  ``use_int8``: the whole beam on the int8 kernel;
    ``int8_tail``: the head exact, the tail int8; ``qt``: the quantized
    transition (default: the static ``quantize_transition``; pass one from
    ``calibrated_qt`` for calibrated scales).  ``share_prefix``: stage k of
    the head steps only the A^(k+1) distinct prefixes, with the same
    scores.  ``rollout_samples`` K > 1: K replicas of each plan roll the
    tail with the Bernoulli head (one Philox seed a step from ``noise``) and
    the plan scores the mean over replicas; exact steps only.
    ``steps``: the packed transitions (``plan_steps``), made here if None
    (a planner makes them once, ``make_planner``).
    """
    if rollout_policy not in POLICIES:
        raise ValueError(f"unknown rollout policy {rollout_policy!r}: {POLICIES}")
    if rollout_samples > 1 and (use_int8 or int8_tail):
        raise ValueError("rollout_samples > 1 needs the exact stochastic transition "
                         "(int8 kernels carry binary latents, nothing to sample)")
    if noise is None and (rollout_samples > 1 or rollout_policy == "random"):
        raise ValueError("sampled steps and the random tail need a PlanNoise")
    if steps is None:
        if (use_int8 or int8_tail) and qt is None:
            qt = quantize_transition(params.transition)
        steps = plan_steps(params, num_actions, qt=qt)
    if (use_int8 or int8_tail) and steps.int8 is None:
        raise ValueError("use_int8 / int8_tail need steps with an int8 transition")
    head_fn = steps.int8 if use_int8 else steps.exact
    tail_fn = steps.int8 if (use_int8 or int8_tail) else steps.exact

    with torch.inference_mode(), no_tf32():
        e, dev = z.shape[0], z.device
        n_a = num_actions
        width = n_a ** (lookahead + 1)
        tail_len = rollout_depth - lookahead
        tail = (noise.tail_actions((e, width, tail_len), n_a)
                if rollout_policy == "random" else None)
        table = _action_table(n_a, lookahead, rollout_depth, rollout_policy, tail)
        table = table.to(dev).expand(e, width, rollout_depth + 1)
        onehot = lambda a: F.one_hot(a, n_a).to(z.dtype)  # noqa: E731
        reward = lambda zb: predict_reward(params.reward_predictor, zb)  # noqa: E731

        # the enumerated head (first action + lookahead), exact under int8_tail
        if share_prefix:
            # Stage k steps the A^(k+1) distinct prefixes (a_0..a_k), base-A
            # a_0-major, the table's row order.
            z_beam, cumulative = z, None
            for k in range(lookahead + 1):
                z_beam = z_beam.repeat_interleave(n_a, dim=0)
                stage_a = torch.arange(n_a, device=dev).repeat(e * n_a ** k)
                z_beam = head_fn(z_beam, onehot(stage_a))
                r = reward(z_beam)
                cumulative = r if cumulative is None else (
                    cumulative.repeat_interleave(n_a, dim=0) + r)
        else:
            z_beam = z.repeat_interleave(width, dim=0)
            cumulative = None
            for i in range(lookahead + 1):
                z_beam = head_fn(z_beam, onehot(table[:, :, i].reshape(-1)))
                r = reward(z_beam)
                cumulative = r if cumulative is None else cumulative + r

        k_rep = rollout_samples
        if k_rep > 1:
            # K replicas of each episode's beam, replica-major
            rep = lambda x: x.reshape(e, 1, width, *x.shape[1:]).expand(  # noqa: E731
                e, k_rep, width, *x.shape[1:]).reshape(e * k_rep * width, *x.shape[1:])
            z_beam, cumulative = rep(z_beam), rep(cumulative)
            seeds = noise.sample_seeds(tail_len)

        # the tradeoff weights reward channel 0 (main.py:483-484), in the
        # greedy tail's choice and in the score
        w_reward = torch.ones(cumulative.shape[1], dtype=torch.float32, device=dev)
        w_reward[0] = negative_positive_tradeoff

        for t in range(tail_len):
            if k_rep > 1:
                step = lambda zb, a, s=seeds[t]: steps.sample(zb, a, s)  # noqa: E731
            else:
                step = tail_fn
            if rollout_policy == "greedy":
                wb = z_beam.shape[0]
                z_next = step(z_beam.repeat_interleave(n_a, dim=0),
                              onehot(torch.arange(n_a, device=dev).repeat(wb)))
                r = reward(z_next)
                choice = (r.to(torch.float32) * w_reward).sum(-1).reshape(
                    wb, n_a).argmax(dim=1)
                rows = torch.arange(wb, device=dev)
                z_beam = z_next.reshape(wb, n_a, *z_next.shape[1:])[rows, choice]
                cumulative = cumulative + r.reshape(wb, n_a, -1)[rows, choice]
            else:
                a_t = table[:, :, lookahead + 1 + t]
                if k_rep > 1:
                    a_t = a_t[:, None, :].expand(e, k_rep, width)
                z_beam = step(z_beam, onehot(a_t.reshape(-1)))
                cumulative = cumulative + reward(z_beam)

        scores = (cumulative * w_reward).sum(dim=1)
        scores = scores.reshape(e, k_rep, width).mean(dim=1)
        return scores.reshape(e, n_a, -1).amax(dim=-1)


def make_planner(params: WorldModel, num_actions: int, lookahead: int = 2,
                 rollout_depth: int = 12, rollout_policy: str = "noop",
                 negative_positive_tradeoff: float = 10.0,
                 use_int8: bool = False, int8_tail: bool = False, qt=None,
                 rollout_samples: int = 1,
                 generator: Optional[torch.Generator] = None,
                 dtype=torch.bfloat16):
    """Returns plan(z, noise=None) -> (best_action, scores (A,)) for one
    latent state z (1, H, W, L); the weights are packed here, once.
    ``generator`` draws the plans' randomness when ``noise`` is None."""
    if (use_int8 or int8_tail) and qt is None:
        qt = quantize_transition(params.transition)
    steps = plan_steps(params, num_actions, dtype=dtype, qt=qt)
    own_noise = None if generator is None else PlanNoise(generator)

    def plan(z, noise=None):
        scores = rollout_reward_table(
            params, z, num_actions, lookahead, rollout_depth, rollout_policy,
            negative_positive_tradeoff, noise=noise or own_noise,
            use_int8=use_int8, int8_tail=int8_tail,
            rollout_samples=rollout_samples, steps=steps)
        return int(best_action(scores)[0]), scores[0]

    return plan


def calibrated_qt(params: WorldModel, z: torch.Tensor, num_actions: int,
                  noise: Optional[PlanNoise] = None, n_samples: int = 32,
                  steps: int = 16):
    """A calibrated QuantizedTransition from a seed latent state z (1, H, W, L).

    Sweeps ``steps`` exact f32 transition steps from ``n_samples`` copies of
    z under random actions (hard-threshold carry) and calibrates per-channel
    activation max ranges over the whole rollout
    (``models/quantized.py::calibrate_transition``, sequence form).
    ``steps`` should cover the planner's beam depth (lookahead +
    rollout_depth): under-covering the visited states makes the requant
    clip, and clipping error compounds step over step.  ``noise`` draws the
    actions (default: a generator on z's device seeded with 0).
    """
    if noise is None:
        noise = PlanNoise(torch.Generator(device=z.device).manual_seed(0))
    zs = z.repeat_interleave(n_samples, dim=0)
    actions = noise.calibration_actions((zs.shape[0], steps), num_actions)
    with no_tf32():
        return calibrate_transition(params.transition, zs,
                                    F.one_hot(actions.to(z.device), num_actions).to(zs.dtype))
