"""Excitation-BPTT "causal backtrack" visualization.

Port of ``scmgan_tpu/analysis/excitation_bptt.py`` (reference
excitation_bptt.py:6-53): roll the transition forward until a step whose
expected |reward| exceeds a threshold; backprop the *localised* reward (the
single largest-|value| cell of the reward map) through the latent rollout;
use each step's |dL/dz| as a mask over the latents and decode the masked
latents into a reversed "what caused this reward" video.

The rollout is the train-mode straight-through transition with fixed
per-step uniforms, so the chain is replayable and has a usable gradient
(the eval-mode threshold's gradient is zero).  The JAX package re-runs the
chain from each step's latent; here one backward pass over the same chain
gives every step's gradient, the same values.  Everything runs in plain
f32 with TF32 off, not through the bf16 kernels: the chain is
differentiated, and a flipped latent bit would change it.
"""

from __future__ import annotations

import os
import time
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from scmgan_tpu_torch.analysis.video import Video
from scmgan_tpu_torch.models.world_model import (
    WorldModel,
    decode,
    predict_reward,
    transition,
)
from scmgan_tpu_torch.utils.device import no_tf32

POLICIES = ("reference", "random")


class BpttNoise:
    """The rollout's randomness, drawn in step order: step t's uniforms of
    the Bernoulli head (a generator seeded ``seed``) and, under the
    ``"random"`` policy, its action (a generator seeded ``seed ^ 0x5EED``).
    A test hands in one that replays the JAX package's ``fold_in`` keys."""

    def __init__(self, seed: int, device):
        self.uniform_gen = torch.Generator(device=device).manual_seed(seed)
        self.action_gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)

    def uniforms(self, t: int, shape) -> torch.Tensor:
        g = self.uniform_gen
        return torch.rand(shape, generator=g, device=g.device)

    def action(self, t: int, num_actions: int) -> int:
        g = self.action_gen
        return int(torch.randint(0, num_actions, (1,), generator=g, device=g.device))


class Backtrack(NamedTuple):
    """A rollout that crossed the threshold at step ``t_hit``: each step's
    latent, summed expected reward and dL/dz of the localised reward."""

    zs: List[torch.Tensor]
    rewards: List[float]
    grads: List[torch.Tensor]
    t_hit: int


def backtrack(params: WorldModel, z0: torch.Tensor, num_actions: int,
              noise: BpttNoise, steps: int = 30, reward_threshold: float = 0.8,
              policy: str = "reference") -> Optional[Backtrack]:
    """Roll from ``z0`` (1, H, W, L) under ``policy``, with ``noise``'s
    draws, until the expected |reward| exceeds ``reward_threshold`` and
    take every step's gradient of the localised reward; None if no step of
    ``steps`` crosses it."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}: one of {POLICIES}")

    def action_at(t):
        # the reference's roll: action 1 at t = 0, then 3
        # (excitation_bptt.py:14)
        a = noise.action(t, num_actions) if policy == "random" else (1 if t == 0 else 3)
        return F.one_hot(torch.tensor([a % num_actions], device=z0.device),
                         num_actions).to(torch.float32)

    zs, rewards = [], []
    with torch.enable_grad(), no_tf32():
        z = z0.detach().to(torch.float32).requires_grad_(True)
        for t in range(steps):
            z = transition(params.transition, z, action_at(t),
                           noise.uniforms(t, z.shape), train=True)
            z.retain_grad()
            r, rmap = predict_reward(params.reward_predictor, z, visualize=True)
            zs.append(z)
            rewards.append(float(r.detach().sum()))
            if abs(rewards[-1]) > reward_threshold:
                break
        else:
            return None
        # the localised reward: only the largest-|value| cell(s) of the
        # map (excitation_bptt.py:35), the mask held out of the gradient
        mask = (rmap.abs() == rmap.abs().max()).to(rmap.dtype).detach()
        (rmap * mask).sum().backward()
    return Backtrack([z.detach() for z in zs], rewards, [z.grad for z in zs],
                     len(zs) - 1)


def visualize_bptt(params: WorldModel, z0: torch.Tensor, num_actions: int,
                   steps: int = 30, reward_threshold: float = 0.8,
                   out_dir: str = ".", filename: Optional[str] = None,
                   seed: int = 0, policy: str = "reference",
                   noise: Optional[BpttNoise] = None) -> Optional[str]:
    """z0: (1, H, W, L) initial latent on the model's device.  Returns the
    video's path, or None if no step's reward crossed the threshold.

    ``policy``: ``"reference"`` replays the reference's roll (action 1,
    then 3 forever); ``"random"`` draws one action a step, for envs (pong)
    where that roll never reaches a predicted score.  ``noise``: the
    rollout's draws (default ``BpttNoise(seed)``)."""
    if noise is None:
        noise = BpttNoise(seed, z0.device)
    bt = backtrack(params, z0, num_actions, noise, steps, reward_threshold, policy)
    if bt is None:
        print("No large expected reward found; skipping excitation BPTT")
        return None
    r_total = bt.rewards[bt.t_hit]
    print("Expected reward of {:.2f} at time t+{}".format(r_total, bt.t_hit))

    if filename is None:
        filename = f"excitation_bptt_{int(time.time())}.mp4"
    vid = Video(os.path.join(out_dir, filename), framerate=10)
    with torch.inference_mode(), no_tf32():
        # forward frames
        for z in bt.zs:
            frame = torch.sigmoid(decode(params.decoder, z))[0]
            vid.write_frame(frame.cpu().numpy(), resize_to=(512, 512))
        # the causal backtrack: reversed masked decodes (excitation_bptt.py:46-52)
        for t in range(bt.t_hit, -1, -1):
            g = bt.grads[t].abs()
            mask = g / (1e-3 + g.max())
            img = decode(params.decoder, bt.zs[t] * mask)[0].sum(dim=-1)
            img = img.clamp(0, 1).cpu().numpy()
            for _ in range(4):
                vid.write_frame(img, resize_to=(512, 512),
                                caption=f"Causal Backtrack, R={r_total:.2f}")
    return vid.finish()
