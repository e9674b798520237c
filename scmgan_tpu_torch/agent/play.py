"""Live MPC episode: play an environment with the learned model
(reference play(), main.py:327-400).

Port of ``scmgan_tpu/agent/play.py``.  Three no-op frames seed the encoder
(the reference uses action index 3 as its "no_op", main.py:335-346,
replicated as ``3 % A``); then each step plans with the batched beam
(``agent.mpc``), acts in the real environment, splits the reward into its
positive and negative parts, re-encodes from the rolling 3-frame window, and
finally writes the episode video and an ``evaluation_metrics_<timestamp>.txt``
score file read by the metric scripts (main.py:397-399;
scripts/print_metrics_minipacman.sh:18-19).  On the card the window step and
the beam run on the transition kernel, its weights packed once an episode.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from scmgan_tpu_torch.agent import mpc
from scmgan_tpu_torch.analysis.video import Video
from scmgan_tpu_torch.models.world_model import WorldModel, encode
from scmgan_tpu_torch.utils.device import no_tf32


def model_device(params: WorldModel) -> torch.device:
    return params.encoder["conv1"]["w"].device


def play(params: WorldModel, datasource, max_steps: int = 300,
         rollout_depth: int = 12, lookahead: int = 2,
         negative_positive_tradeoff: float = 10.0, out_dir: str = ".",
         verbose: bool = True, seed: Optional[int] = None,
         use_int8: bool = False, rollout_samples: int = 1,
         rollout_policy: str = "noop", stall_patience: int = 10,
         env=None, write_video: bool = True, dtype=torch.bfloat16):
    """Returns (cumulative_reward, steps).  Writes video + metrics file.

    ``rollout_policy``: tail policy for the planning beam: the reference's
    "noop"/"random" (main.py:467-471) plus the 1-step-"greedy" tail
    (agent/mpc.py).  ``use_int8``: the whole beam on the int8 kernel with a
    ``calibrated_qt`` from the first latent state.  ``dtype``: the
    transition's packing (``mpc.plan_steps``): bf16 the card's kernel, f32
    the plain f32 version.

    ``stall_patience``: anti-stall countermeasure (0 disables).  The
    deterministic beam has a failure mode where the model hallucinates
    future reward for an action that doesn't change the real state, and the
    argmax replays it forever.  If the feature frame is bit-identical for
    ``stall_patience`` consecutive real steps, one uniformly random different
    action is taken (from ``np.random.default_rng(seed)``, as the JAX
    package's host loop draws it); planning resumes from the new state.

    ``env``: a ``HostEnv`` to play in (default: ``datasource.make_env``).
    The model and the env's frames meet on the model's device.
    """
    num_actions = datasource.binary_input_channels
    device = model_device(params)
    env = env if env is not None else datasource.make_env(screen_size=512)
    no_op = 3 % num_actions  # reference literally uses 3 (main.py:335)

    obs = env.reset()
    s_0, _ = datasource.convert_frame(obs)
    obs, _, done, _ = env.step(no_op)
    s_1, _ = datasource.convert_frame(obs)
    obs, _, done, _ = env.step(no_op)
    s_2, _ = datasource.convert_frame(obs)
    state_list = [np.asarray(s_0), np.asarray(s_1), np.asarray(s_2)]

    steps = mpc.plan_steps(params, num_actions, dtype=dtype)

    def encode_window(frames):
        stacked = torch.from_numpy(np.stack(frames))[None].to(device)  # (1, 3, H, W, C)
        return encode(params.encoder, stacked)

    def onehot(a):
        return F.one_hot(torch.tensor([a], device=device), num_actions).to(torch.float32)

    with torch.inference_mode(), no_tf32():
        z = steps.exact(encode_window(state_list), onehot(no_op))
        qt = None
        if use_int8:
            qt = mpc.calibrated_qt(params, z, num_actions, noise=mpc.PlanNoise(
                torch.Generator(device=device).manual_seed(seed or 0)))
            steps = steps._replace(int8=mpc.int8_step(qt))

    ts = int(time.time())
    vid = (Video(os.path.join(out_dir, f"SimpleRolloutAgent-{ts}.mp4"), framerate=10)
           if write_video else None)
    cumulative_reward = 0.0
    cumulative_positive = 0.0
    cumulative_negative = 0.0
    t = 2
    done = False
    plan_gen = torch.Generator(device=device)
    plan_gen.manual_seed(seed if seed is not None else int(time.time()))
    noise = mpc.PlanNoise(plan_gen)
    stall_rng = np.random.default_rng(seed if seed is not None else 0)
    stalled = 0
    prev_frame = np.asarray(state_list[-1])
    while not done:
        scores = mpc.rollout_reward_table(
            params, z, num_actions, lookahead, rollout_depth, rollout_policy,
            negative_positive_tradeoff, noise=noise, use_int8=use_int8,
            rollout_samples=rollout_samples, steps=steps)
        max_a = int(mpc.best_action(scores)[0])
        if stall_patience and stalled >= stall_patience:
            others = [a for a in range(num_actions) if a != max_a]
            max_a = int(stall_rng.choice(others)) if others else max_a
            stalled = 0
            if verbose:
                print(f"t={t} stall break: random action {max_a}")

        obs, reward, done, info = env.step(max_a)
        rewards_info = [v for v in info.values()] if len(info) > 1 else []
        if rewards_info:
            positive = sum(v for v in rewards_info if v > 0)
            negative = sum(v for v in rewards_info if v < 0)
        else:
            positive = max(0.0, reward)
            negative = min(0.0, reward)
        cumulative_positive += positive
        cumulative_negative -= negative
        cumulative_reward += reward

        ftr_state, rgb_state = datasource.convert_frame(obs)
        caption = "Negative Reward: {}    Positive Reward: {}".format(
            int(cumulative_negative), int(cumulative_positive))
        if verbose:
            score_strs = " ".join(f"{float(s):.02f}" for s in scores[0].cpu().numpy())
            print(f"t={t} curr. r={cumulative_reward:.02f} future r: {score_strs}")
        if vid is not None:
            vid.write_frame(rgb_state, resize_to=(512, 512), caption=caption)

        ftr_np = np.asarray(ftr_state)
        stalled = stalled + 1 if np.array_equal(ftr_np, prev_frame) else 0
        prev_frame = ftr_np
        state_list = state_list[1:] + [ftr_np]
        with torch.inference_mode(), no_tf32():
            z = steps.exact(encode_window(state_list), onehot(max_a))
        t += 1
        if t > max_steps:
            print("Ending evaluation due to time limit")
            break
    if vid is not None:
        vid.finish()
    msg = f"Finished at t={t} with cumulative reward {cumulative_reward}"
    with open(os.path.join(out_dir, f"evaluation_metrics_{int(time.time())}.txt"),
              "w") as fp:
        fp.write(msg + "\n")
    print(msg)
    return cumulative_reward, t
