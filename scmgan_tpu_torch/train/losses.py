"""Training objectives: one function over (params, batch, noise).

Port of ``scmgan_tpu/train/losses.py`` with every option of its
``world_model_loss`` (losses.py:117):

  * multi-step BPTT reconstruction (pixel BCE) with done masking
  * reward MSE, theta-scheduled and REWARD_COEF-weighted
  * truncated BPTT (the transition input detached at t > 1)
  * latent overshooting and latent TD(lambda) over a (B, S, H, W, L) slot
    buffer whose slots advance in one batched transition call per step
  * the counterfactual factor-swap and action-control regularizers
  * the activation and transition L1 terms

The JAX package's ``lax.scan`` over time is a Python loop here.  Dtypes
follow the JAX function, not ``torch.autocast``: the caller hands ``obs`` in
the compute dtype, every conv casts its f32 weight to the activation's
dtype, sigmoid and softmax run in that dtype, and each loss term is cast to
f32 before it is summed.

Randomness: every draw comes from one ``LossNoise`` object passed in place
of JAX's key, so that a test can pass one that replays the JAX key schedule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from scmgan_tpu_torch.models.world_model import (
    WorldModel,
    decode,
    encode,
    predict_reward,
    transition,
)


class LossConfig(NamedTuple):
    """The loss's static switches (losses.py:41)."""

    horizon: int                 # this iteration's prediction horizon
    truncate_bptt: bool = False
    latent_overshooting: bool = False
    latent_td: bool = False
    td_steps: int = 3
    enable_cf_shuffle: bool = False
    enable_cf_control: bool = False
    counterfactual_horizon: int = 1
    reward_coef: float = 1e-3
    td_lambda: float = 0.9
    cf_lambda: float = 1e-2
    activation_l1_coef: float = 0.0   # reference default: disabled
    transition_l1_coef: float = 0.0   # reference default: disabled
    deterministic_transition: bool = False  # ablation: no Bernoulli sampling
    remat_transition: bool = False    # recompute the BPTT transition's
                                      # activations in backward
    scan_unroll: int = 1              # no effect in the port's eager loop


class LossNoise:
    """Every random draw of ``world_model_loss``, from ``generator`` on its
    device.  The uniforms come in the dtype of the probabilities they are
    compared with, as ``jax.random.bernoulli`` draws them."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _uniform(self, shape, dtype) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=self.generator.device, dtype=dtype)

    def transition(self, t: int, shape, dtype) -> torch.Tensor:
        """The straight-through head's uniforms at BPTT step t."""
        return self._uniform(shape, dtype)

    def overshoot(self, t: int, shape, dtype) -> torch.Tensor:
        """The uniforms of step t's advance of the (B * S) slot buffer."""
        return self._uniform(shape, dtype)

    def swap_indices(self, b: int, latent_dim: int):
        """The two latent channels each sample of the CF swap exchanges."""
        g = self.generator
        return tuple(torch.randint(0, latent_dim, (b,), generator=g,
                                   device=g.device) for _ in range(2))

    def permutation(self, b: int) -> torch.Tensor:
        """The CF action-control term's shuffle of the batch."""
        return torch.randperm(b, generator=self.generator,
                              device=self.generator.device)

    def shuffle_batch(self, actions_oh: torch.Tensor) -> torch.Tensor:
        """``actions_oh`` (B, ...) with its batch rows in ``permutation``'s
        order."""
        return actions_oh[self.permutation(actions_oh.shape[0])]

    def rollout(self, shape, dtype) -> torch.Tensor:
        """The uniforms of one step of a CF roll-out (of the term whose
        indices or permutation were drawn last)."""
        return self._uniform(shape, dtype)


class ShardedLossNoise(LossNoise):
    """This process's rows of the draws of a global batch's ``noise``
    (``parallel/mesh.py::shard_train_step``).

    Every process of the mesh draws the GLOBAL shapes from a ``noise`` that
    they all seed alike and keeps rows [offset, offset + local): so a step
    over a 'data'-split batch draws what the one-device step draws.  The
    slot buffer is batch-major ((B * S) rows), so its rows are
    [offset * S, (offset + local) * S).  The action-control shuffle crosses
    the batch: the actions (inputs, with no gradient) are all-gathered over
    ``group`` (the 'data' axis) before the global permutation."""

    def __init__(self, noise: LossNoise, offset: int, local: int,
                 global_batch: int, group=None):
        self.noise, self.offset, self.local = noise, offset, local
        self.global_batch, self.group = global_batch, group

    def _rows(self, x: torch.Tensor, per: int = 1) -> torch.Tensor:
        return x[self.offset * per:(self.offset + self.local) * per]

    def _wide(self, shape, per: int = 1):
        return (self.global_batch * per, *shape[1:])

    def transition(self, t: int, shape, dtype) -> torch.Tensor:
        return self._rows(self.noise.transition(t, self._wide(shape), dtype))

    def overshoot(self, t: int, shape, dtype) -> torch.Tensor:
        slots = shape[0] // self.local
        return self._rows(self.noise.overshoot(t, self._wide(shape, slots), dtype), slots)

    def swap_indices(self, b: int, latent_dim: int):
        return tuple(self._rows(i) for i in
                     self.noise.swap_indices(self.global_batch, latent_dim))

    def shuffle_batch(self, actions_oh: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        parts = actions_oh.to(torch.float32).contiguous()
        if self.global_batch != self.local:
            gathered = [torch.empty_like(parts) for _ in
                        range(self.global_batch // self.local)]
            dist.all_gather(gathered, parts, group=self.group)
            parts = torch.cat(gathered)
        perm = self.noise.permutation(self.global_batch).to(parts.device)
        return self._rows(parts[perm]).to(actions_oh.dtype)

    def rollout(self, shape, dtype) -> torch.Tensor:
        return self._rows(self.noise.rollout(self._wide(shape), dtype))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative: +1 at x == 0, where ``torch.abs``'s is 0.
    Sampled latents are exactly 0 or 1, so the L1 and CF terms meet x == 0
    in most elements."""
    return torch.where(x >= 0, x, -x)


def bce_from_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element binary cross entropy from logits, the stable form of the
    reference's F.binary_cross_entropy(sigmoid(logits), target)."""
    return (torch.clamp(logits, min=0.0) - logits * targets
            + torch.log1p(torch.exp(-_abs(logits))))


def decoder_pixel_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B,): BCE mean over pixels and channels."""
    return bce_from_logits(logits.to(torch.float32),
                           targets.to(torch.float32)).mean(dim=(1, 2, 3))


def latent_state_loss(target: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """(B, H, W, L) -> (B,): latent MSE."""
    d = target.to(torch.float32) - predicted.to(torch.float32)
    return (d * d).mean(dim=(1, 2, 3))


def _swap_two_factors(noise: LossNoise, z: torch.Tensor, latent_dim: int):
    """Per-sample swap of two random latent channels of z (B, H, W, L).
    Returns (z_swapped, unswapped (B, L)); as in the reference, idx_a ==
    idx_b swaps nothing but still counts as swapped (losses.py:95)."""
    b, h, w, _ = z.shape
    idx_a, idx_b = noise.swap_indices(b, latent_dim)
    rows = torch.arange(b, device=z.device)
    perm = torch.arange(latent_dim, device=z.device).repeat(b, 1)
    perm[rows, idx_a] = idx_b
    perm[rows, idx_b] = idx_a
    z_swapped = torch.gather(z, -1, perm[:, None, None, :].expand(b, h, w, latent_dim))
    unswapped = torch.ones((b, latent_dim), dtype=torch.float32, device=z.device)
    unswapped[rows, idx_a] = 0.0
    unswapped[rows, idx_b] = 0.0
    return z_swapped, unswapped


def _pair_weights(t: int, slot: int, s: int, valid, cfg: LossConfig):
    """The weight of each slot's latent-MSE at step t (losses.py:284-296):
    overshooting weights every valid pair t_a in [2, t - 2] by td_lambda
    once; TD(lambda) weights slots of age 1..td_steps by td_lambda ** age."""
    weights = []
    for i in range(s):
        if cfg.latent_overshooting:
            ok = 2 <= i <= t - 2
            weight = cfg.td_lambda
        else:
            age = (t - i) % s
            ok = 1 <= age <= cfg.td_steps and i != slot
            weight = cfg.td_lambda ** age
        weights.append(weight if ok and valid[i] else 0.0)
    return weights


def world_model_loss(params: WorldModel, batch, noise: LossNoise, theta,
                     cf_active, cfg: LossConfig):
    """Full training objective for one batch (losses.py:117).

    batch: (obs (B, T, H, W, C) in the compute dtype, rewards (B, T, R),
    dones (B, T), actions (B, T)) with T >= cfg.horizon.  theta: train_iter /
    train_iters; cf_active: 1.0 on iterations where the CF regularizers fire.
    Returns (loss, metrics) as f32 tensors.
    """
    obs, rewards, dones, actions = batch
    b, t_total = obs.shape[0], obs.shape[1]
    horizon = cfg.horizon
    if t_total < horizon:
        raise ValueError(f"batch has {t_total} steps, horizon is {horizon}")
    latent_dim = params.encoder["conv4"]["w"].shape[-1]
    num_actions = params.transition["conv1"]["w"].shape[2] - latent_dim
    trans = params.transition
    det = cfg.deterministic_transition

    f32 = torch.float32
    dev = obs.device
    theta = torch.as_tensor(theta, dtype=f32, device=dev)
    cf_active = torch.as_tensor(cf_active, dtype=f32, device=dev)
    rewards = rewards.to(f32)
    done_f = dones.to(f32)
    actions_oh = F.one_hot(actions.long(), num_actions).to(obs.dtype)

    def step(z, a, u):
        return transition(trans, z, a, u, train=True, deterministic=det)

    def draw(sampler, *args):
        return None if det else sampler(*args)

    z = encode(params.encoder, obs[:, 0:3])
    z_orig = z
    hh, ww = z.shape[1], z.shape[2]

    use_lo = cfg.latent_overshooting
    use_td = cfg.latent_td
    s = horizon if use_lo else (cfg.td_steps + 2 if use_td else 1)
    lo_buf = torch.zeros((b, s, hh, ww, latent_dim), dtype=z.dtype, device=dev)
    lo_valid = [False] * s

    zero = torch.zeros((), dtype=f32, device=dev)
    active = torch.ones((b,), dtype=f32, device=dev)
    loss, lo_loss, rew_sum, rec_sum = zero, zero, zero, zero
    for t in range(1, horizon - 1):
        active = active * (1.0 - done_f[:, t])

        # reward loss (reference main.py:180-185)
        expected_r = predict_reward(params.reward_predictor, z).to(f32)
        r_diff = torch.mean(
            torch.mean((expected_r - rewards[:, t]) ** 2, dim=1) * active)

        # reconstruction loss (main.py:187-197)
        logits = decode(params.decoder, z)
        rec_loss = torch.mean(decoder_pixel_loss(logits, obs[:, t]) * active)

        loss = loss + theta * cfg.reward_coef * r_diff + rec_loss
        if cfg.activation_l1_coef:
            l1 = _abs(z.to(f32)).mean(dim=(1, 2, 3))
            loss = loss + theta * cfg.activation_l1_coef * torch.mean(l1 * active)

        # truncated BPTT: detach the transition input (main.py:192-193)
        z_in = z.detach() if cfg.truncate_bptt and t > 1 else z
        u = draw(noise.transition, t, z_in.shape, z_in.dtype)
        if cfg.remat_transition:
            new_z = checkpoint(step, z_in, actions_oh[:, t], u,
                               use_reentrant=False)
        else:
            new_z = step(z_in, actions_oh[:, t], u)

        if cfg.transition_l1_coef:
            tl1 = _abs((new_z - z_in).to(f32)).mean(dim=(1, 2, 3))
            loss = loss + theta * cfg.transition_l1_coef * torch.mean(tl1 * active)

        if use_lo or use_td:
            # Advance every valid slot with action[t-1], then write the
            # fresh (detached-target) encoding of frames t-1..t+1 to slot
            # t mod S (main.py:217-234).  Both calls are recomputed in
            # backward, as the JAX package's jax.checkpoint does: otherwise
            # the S*B-batch activations of every step stay alive.
            flat = lo_buf.reshape(b * s, hh, ww, latent_dim)
            a_rep = actions_oh[:, t - 1].repeat_interleave(s, dim=0)
            u_lo = draw(noise.overshoot, t, flat.shape, flat.dtype)
            adv = checkpoint(step, flat, a_rep, u_lo, use_reentrant=False)
            valid = torch.tensor(lo_valid, device=dev)[None, :, None, None, None]
            lo_buf = torch.where(valid, adv.reshape(lo_buf.shape), lo_buf)
            fresh = checkpoint(encode, params.encoder, obs[:, t - 1:t + 2],
                               use_reentrant=False)
            slot = t % s
            lo_buf = torch.cat([lo_buf[:, :slot], fresh[:, None],
                                lo_buf[:, slot + 1:]], dim=1)
            w_pair = torch.tensor(_pair_weights(t, slot, s, lo_valid, cfg),
                                  dtype=f32, device=dev)
            d = fresh.detach()[:, None].to(f32) - lo_buf.to(f32)
            per_slot = ((d * d).mean(dim=(2, 3, 4)) * active[:, None]).mean(dim=0)
            lo_loss = lo_loss + torch.sum(w_pair * per_slot)
            lo_valid[slot] = True

        z = new_z
        rew_sum = rew_sum + r_diff
        rec_sum = rec_sum + rec_loss

    metrics = {"reward_loss": rew_sum, "reconstruction_loss": rec_sum}
    if use_lo or use_td:
        loss = loss + theta * lo_loss
        metrics["lo_loss"] = lo_loss
    z_final = z

    # counterfactual disentanglement (main.py:236-262)
    if cfg.enable_cf_shuffle:
        z_cf, unswapped = _swap_two_factors(noise, z_orig, latent_dim)
        for t in range(1, cfg.counterfactual_horizon):
            z_cf = step(z_cf, actions_oh[:, t],
                        draw(noise.rollout, z_cf.shape, z_cf.dtype))
        drift = _abs(z_final.to(f32) - z_cf.to(f32)).mean(dim=(1, 2))
        cf_loss = cfg.cf_lambda * torch.mean((drift * unswapped).mean(dim=-1) * active)
        loss = loss + cf_active * cf_loss
        metrics["cf_disentanglement_loss"] = cf_loss

    # counterfactual action control (main.py:264-283): the reference's
    # np.random.shuffle(actions) permutes the batch axis
    if cfg.enable_cf_control:
        cf_actions = noise.shuffle_batch(actions_oh)
        z_cf = z_orig
        for t in range(1, cfg.counterfactual_horizon):
            z_cf = step(z_cf, cf_actions[:, t],
                        draw(noise.rollout, z_cf.shape, z_cf.dtype))
        div = _abs(z_final.to(f32) - z_cf.to(f32)).mean(dim=(1, 2, 3))
        ctrl_loss = cfg.cf_lambda * torch.mean(-torch.log(div + 1e-3) * active)
        loss = loss + cf_active * ctrl_loss
        metrics["cf_control_loss"] = ctrl_loss

    metrics["loss"] = loss
    return loss, metrics
