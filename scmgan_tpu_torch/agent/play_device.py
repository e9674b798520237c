"""Whole-episode MPC evaluation, every episode in one batched loop.

Port of ``scmgan_tpu/agent/play_device.py`` (``_play_episodes``,
``play_on_device``).  The host loop (agent/play.py, reference
main.py:327-400) copies every frame and score to the host.  For the
on-device environments nothing in an episode needs the host: this loop keeps
the protocol (reset, 3 no-op seed frames, the per-step planning beam of
``agent.mpc.rollout_reward_table``, the env step, the positive/negative
reward split, the rolling 3-frame re-encode, the anti-stall kick, the
300-step cap) on the device, for all E episodes at once, so each beam step is
one launch of the transition kernel at batch E x beam width.  The JAX
package compiles the same protocol into one ``vmap(scan)``; here it is an
eager loop whose steps never wait for the card.

Protocol parity with ``play``: rewards of the two no-op seed steps are
discarded, accumulation is masked after done, and the cap is the host
loop's ``t > max_steps`` break (t runs 2..max_steps inclusive); score files
have the reference's format (main.py:397-399).

Divergences (documented): the anti-stall kick draws from the torch
generator, not from the host loop's numpy generator (the same uniform over
the other actions), as the JAX package's device loop draws from jax.random;
episodes that end early still step, masked.  The JAX package limits the
episodes per program by a lane budget that works around a remote TPU
worker fault (docs/play64_crash_matrix.json); the port has no such limit,
and splits the episodes only where the card's memory needs it
(``_episode_chunk``).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.nn.functional as F

from scmgan_tpu_torch.agent import mpc
from scmgan_tpu_torch.agent.play import model_device
from scmgan_tpu_torch.envs.base import EnvSpec
from scmgan_tpu_torch.models.world_model import WorldModel, encode
from scmgan_tpu_torch.utils.device import no_tf32

# Bytes a beam state holds per latent pixel at its peak, besides the
# kernel's scratch (4 x hidden bf16 activations): its f32 latents and their
# one-hot-expanded and bf16 copies, the kernel's bf16 output and the reward
# predictor's f32 activations (32 channels, twice).
_BEAM_BYTES_PER_PIXEL = 512


def _episode_chunk(spec: EnvSpec, hidden: int, num_actions: int, lookahead: int,
                   rollout_policy: str, rollout_samples: int,
                   device: torch.device) -> Optional[int]:
    """The most episodes one batched loop takes on ``device``: half the
    card's free memory over an episode's peak beam memory.  None (no
    limit) off the card."""
    if device.type != "cuda":
        return None
    width = num_actions ** (lookahead + 1) * max(rollout_samples, 1)
    if rollout_policy == "greedy":
        width *= num_actions          # the greedy tail's A-wide transient
    per_episode = width * spec.height * spec.width * (8 * hidden + _BEAM_BYTES_PER_PIXEL)
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, free // 2 // per_episode)


def _play_episodes(params: WorldModel, spec: EnvSpec, state, generator: torch.Generator,
                   steps: mpc.PlanSteps, max_steps: int, lookahead: int,
                   rollout_depth: int, rollout_policy: str,
                   negative_positive_tradeoff: float, rollout_samples: int,
                   stall_patience: int):
    """(cum_reward, cum_pos, cum_neg, steps), each (E,), for the E episodes
    that start from ``state``."""
    num_actions = spec.num_actions
    e = state[0].shape[0]
    dev = state[0].device
    needs_noise = rollout_samples > 1 or rollout_policy == "random"
    noise = mpc.PlanNoise(generator)
    onehot = lambda a: F.one_hot(a, num_actions).to(torch.float32)  # noqa: E731
    no_op = torch.full((e,), 3 % num_actions, dtype=torch.int64, device=dev)

    frames = [spec.render(state)]
    for _ in range(2):
        state, _, _ = spec.step(state, no_op, spec.draw_noise(e, generator))
        frames.append(spec.render(state))
    window = torch.stack(frames, dim=1)                     # (E, 3, H, W, C)
    z = steps.exact(encode(params.encoder, window), onehot(no_op))

    f32 = torch.float32
    cum, pos, neg = (torch.zeros(e, dtype=f32, device=dev) for _ in range(3))
    alive = torch.ones(e, dtype=f32, device=dev)
    n_steps = torch.full((e,), 2, dtype=torch.int64, device=dev)
    stalled = torch.zeros(e, dtype=torch.int64, device=dev)
    for _ in range(2, max_steps + 1):
        scores = mpc.rollout_reward_table(
            params, z, num_actions, lookahead, rollout_depth, rollout_policy,
            negative_positive_tradeoff, noise=noise if needs_noise else None,
            rollout_samples=rollout_samples, steps=steps)
        max_a = mpc.best_action(scores)
        if stall_patience:
            kick = stalled >= stall_patience
            r = torch.randint(0, num_actions - 1, (e,), generator=generator, device=dev)
            max_a = torch.where(kick, r + (r >= max_a).to(torch.int64), max_a)
            stalled = torch.where(kick, 0, stalled)

        state, reward_vec, done = spec.step(state, max_a, spec.draw_noise(e, generator))
        rv = reward_vec.to(f32)
        cum = cum + rv.sum(dim=-1) * alive
        pos = pos + torch.clamp(rv, min=0.0).sum(dim=-1) * alive
        neg = neg - torch.clamp(rv, max=0.0).sum(dim=-1) * alive

        frame = spec.render(state)
        same = (frame == window[:, -1]).flatten(1).all(dim=1)
        stalled = torch.where(same, stalled + 1, 0)
        window = torch.cat([window[:, 1:], frame[:, None]], dim=1)
        z = steps.exact(encode(params.encoder, window), onehot(max_a))
        n_steps = n_steps + alive.to(torch.int64)
        alive = alive * (1.0 - done.to(f32))
    return cum, pos, neg, n_steps


def play_on_device(params: WorldModel, datasource, episodes: int = 10,
                   max_steps: int = 300, rollout_depth: int = 12,
                   lookahead: int = 2,
                   negative_positive_tradeoff: float = 10.0,
                   rollout_policy: str = "noop", rollout_samples: int = 1,
                   stall_patience: int = 10, seed0: int = 0,
                   out_dir: Optional[str] = None, verbose: bool = True,
                   start_state=None, dtype=torch.bfloat16):
    """Run ``episodes`` MPC episodes on the model's device in one batched
    loop; returns (rewards list, steps list).

    A generator on that device seeded with ``seed0`` draws the episodes'
    starts and every later random number; ``start_state`` (a batched state
    of ``episodes`` envs) replaces the drawn starts, so a test can replay
    the JAX package's episodes.  ``dtype``: the transition's packing
    (``mpc.plan_steps``), once for all episodes.

    Memory: the transition kernel's scratch is 4·B·H·W·hidden bf16 for a
    batch of B beam states, about 5.4 GB for 20 pong episodes x 64 beams
    (B = 1280, 64x64, hidden 128), and 4x that for the greedy tail's A-wide
    transient; the episodes run in chunks only where they would pass half
    the card's free memory (``_episode_chunk``).  Per-episode results do not
    depend on the chunking's boundaries except through the generator's
    stream.

    Writes reference-format score files when ``out_dir`` is given
    (main.py:397-399), named ``evaluation_metrics_<ts>_<seed0 + i>.txt``:
    the episodes finish in the same second, so a per-second timestamp alone
    would collide.
    """
    spec = datasource.spec if hasattr(datasource, "spec") else datasource
    device = model_device(params)
    hidden = params.transition["conv2"]["w"].shape[-1]
    t0 = time.time()
    with torch.inference_mode(), no_tf32():
        steps = mpc.plan_steps(params, spec.num_actions, dtype=dtype)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed0)
        if start_state is None:
            start_state = spec.reset(episodes, device, generator)
        chunk = _episode_chunk(spec, hidden, spec.num_actions, lookahead,
                               rollout_policy, rollout_samples, device) or episodes
        cum, n_steps = [], []
        for e0 in range(0, episodes, chunk):
            state = type(start_state)(*(x[e0:e0 + chunk] for x in start_state))
            c, _, _, st = _play_episodes(
                params, spec, state, generator, steps, max_steps, lookahead,
                rollout_depth, rollout_policy, float(negative_positive_tradeoff),
                rollout_samples, stall_patience)
            cum.extend(c.tolist())
            n_steps.extend(st.tolist())
    if verbose:
        print(f"play_on_device: {episodes} episodes in {time.time() - t0:.1f}s  "
              f"rewards={cum}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        ts = int(time.time())
        for i, (r, t) in enumerate(zip(cum, n_steps)):
            with open(os.path.join(out_dir, f"evaluation_metrics_{ts}_{seed0 + i}.txt"),
                      "w") as fp:
                fp.write(f"Finished at t={t} with cumulative reward {r}\n")
    return cum, n_steps
