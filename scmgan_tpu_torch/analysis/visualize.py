"""Evaluation visualizations: reconstruction videos, forward-simulation
videos, the planning video, and the compositing helpers.

Port of ``scmgan_tpu/analysis/visualize.py``, content parity with the
reference's visualize_reconstruction (main.py:589-643) and
visualize_forward_simulation / simulate_trajectory_from_actions
(main.py:698-775): ground truth beside free-run predictions, per-pixel
reward overlays (blue positive, red negative) and the per-factor latent
grid.

Every video frame's window is a batch element, as JAX's vmap makes it: the
reconstruction rollout advances all T - 3 - offset windows together, so
each transition step is one call at that batch.  On the card the eval-mode
transition runs on the ``fused_transition`` kernel (threshold head) and the
logits on ``fused_decode``, which equals ``decode`` by linearity
(``analysis/mse.py::serving_steps``).  The host composites numpy panels
and encodes the video.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from scmgan_tpu_torch.analysis.mse import serving_steps
from scmgan_tpu_torch.analysis.video import Video, resize_nearest, to_uint8
from scmgan_tpu_torch.models.world_model import WorldModel, encode, predict_reward


def format_reward_vector(reward) -> str:
    return " ".join("{:.2f}".format(float(r)) for r in np.asarray(reward).ravel())


def factor_grid(z: np.ndarray, pad: int = 2) -> np.ndarray:
    """(H, W, L) latent map -> tiled grayscale grid image (H', W')."""
    h, w, latent = z.shape
    cols = int(np.ceil(np.sqrt(latent)))
    rows = int(np.ceil(latent / cols))
    grid = np.zeros((rows * (h + pad), cols * (w + pad)), np.float32)
    for i in range(latent):
        r, c = divmod(i, cols)
        grid[r * (h + pad): r * (h + pad) + h,
             c * (w + pad): c * (w + pad) + w] = z[:, :, i]
    return grid


def reward_overlay(rgb: np.ndarray, reward_map: np.ndarray) -> np.ndarray:
    """Overlay positive reward in blue, negative in red, on an (H, W, 3)
    image (reference composite_rgb_reward_factor_image, main.py:663-678).
    reward_map: (h, w, R) signed."""
    h, w = rgb.shape[:2]
    signed = np.asarray(reward_map).sum(axis=-1)
    pos = np.clip(signed, 0, 1)
    neg = np.clip(-signed, 0, 1)
    up = resize_nearest(pos[:, :, None], (h, w))[:, :, 0]
    un = resize_nearest(neg[:, :, None], (h, w))[:, :, 0]
    out = rgb.astype(np.float32).copy()
    out[:, :, 2] = np.clip(out[:, :, 2] + up, 0, 1)
    out[:, :, 0] = np.clip(out[:, :, 0] + un, 0, 1)
    return out


def _hstack_panels(*panels, height: int = 256) -> np.ndarray:
    resized = []
    for p in panels:
        img = to_uint8(p)
        scale = height / img.shape[0]
        tw = max(1, int(img.shape[1] * scale))
        resized.append(resize_nearest(img, (height, tw)))
    return np.concatenate(resized, axis=1)


def _onehot(actions: torch.Tensor, num_actions: int, dtype) -> torch.Tensor:
    return F.one_hot(actions.long(), num_actions).to(dtype)


# --------------------------------------------------------------------------
# reconstruction videos (offsets {1, 3})
# --------------------------------------------------------------------------

@torch.inference_mode()
def _reconstruction_rollout(params: WorldModel, obs, actions, num_actions: int,
                            offset: int):
    """All video frames at once: window t in [3, T - offset) is a batch
    element.  Encode frames t-2..t, advance with action t-1 (reference
    main.py:606-613), then ``offset`` more steps.  Returns (logits, reward
    vector, reward map, latents) per window, on the device."""
    transition_fn, decode_fn = serving_steps(params, num_actions)
    t_total = obs.shape[1]
    ts = torch.arange(3, t_total - offset, device=obs.device)
    actions_oh = _onehot(actions[0], num_actions, obs.dtype)      # (T, A)
    frames = obs[0][ts[:, None] + torch.arange(-2, 1, device=obs.device)]
    z = encode(params.encoder, frames)
    z = transition_fn(z, actions_oh[ts - 1])
    for i in range(offset):
        z = transition_fn(z, actions_oh[ts + i])
    logits = decode_fn(z).to(torch.float32)
    r, rmap = predict_reward(params.reward_predictor, z.to(torch.float32),
                             visualize=True)
    return logits, r, rmap, z


def visualize_reconstruction(params: WorldModel, datasource, train_iter: int = 0,
                             timesteps: int = 45, offsets=(1, 3),
                             out_dir: str = ".",
                             generator: Optional[torch.Generator] = None):
    """Prediction + reward videos for each offset (reference main.py:589-643;
    artifact names prediction_{offset:02d}_iter_{iter:06d} and
    reward_prediction_{offset:02d}_iter_{iter:06d}).  ``generator`` draws
    the trajectory (default: the datasource's own)."""
    obs, rewards, dones, actions = datasource.collect(1, timesteps, generator=generator)
    num_actions = datasource.binary_input_channels
    obs_np = obs[0].cpu().numpy()
    written = []
    for offset in offsets:
        logits, rvecs, rmaps, zs = _reconstruction_rollout(
            params, obs, actions, num_actions, offset)
        preds = torch.sigmoid(logits).cpu().numpy()
        rmaps, zs = rmaps.cpu().numpy(), zs.to(torch.float32).cpu().numpy()
        vid_rgb = Video(os.path.join(
            out_dir, f"prediction_{offset:02d}_iter_{train_iter:06d}.mp4"),
            framerate=3)
        vid_reward = Video(os.path.join(
            out_dir, f"reward_prediction_{offset:02d}_iter_{train_iter:06d}.mp4"),
            framerate=3)
        for i in range(preds.shape[0]):
            t = 3 + i
            vid_rgb.write_frame(_hstack_panels(obs_np[t + offset], preds[i]))
            overlay = reward_overlay(preds[i], rmaps[i])
            vid_reward.write_frame(_hstack_panels(overlay, factor_grid(zs[i])))
        written.append(vid_rgb.finish())
        written.append(vid_reward.finish())
    print(f"Finished generating forward-prediction videos: {written}")
    return written


# --------------------------------------------------------------------------
# planning visualization + raw trajectory video (reference main.py:403-444)
# --------------------------------------------------------------------------

def generate_trajectory_video(datasource, out_dir: str = ".",
                              filename: str = "example_trajectory.mp4",
                              timesteps: int = 60,
                              generator: Optional[torch.Generator] = None):
    """Raw datasource rollout video (reference generate_trajectory_video,
    main.py:403-411)."""
    obs, *_ = datasource.collect(1, timesteps, generator=generator)
    vid = Video(os.path.join(out_dir, filename), framerate=10)
    for frame in obs[0].cpu().numpy():
        vid.write_frame(frame, resize_to=(256, 256))
    return vid.finish()


@torch.inference_mode()
def _planning_rollout(params: WorldModel, z, actions, num_actions: int,
                      rollout_depth: int):
    """A beam of futures for the planning video, all rollouts advancing as
    one batch (the reference loops in Python, main.py:414-444).  Returns
    frames (T, width, H, W, C), cumulative rewards (T, width, R) and the
    final cumulative reward (width, R)."""
    transition_fn, decode_fn = serving_steps(params, num_actions)
    width = actions.shape[0]
    z_beam = z.expand((width,) + tuple(z.shape[1:]))
    num_rewards = params.reward_predictor["conv2"]["w"].shape[-1] // 3
    cum = torch.zeros((width, num_rewards), dtype=torch.float32, device=z.device)
    frames, cums = [], []
    for t in range(actions.shape[1]):
        z_beam = transition_fn(z_beam, _onehot(actions[:, t], num_actions, z.dtype))
        frames.append(torch.sigmoid(decode_fn(z_beam).to(torch.float32)))
        cum = cum + predict_reward(params.reward_predictor, z_beam.to(torch.float32))
        cums.append(cum)
    return torch.stack(frames), torch.stack(cums), cum


def generate_planning_visualization(params: WorldModel, z, num_actions: int,
                                    vid: Video, lookahead: int = 3,
                                    rollout_depth: int = 20,
                                    caption_title: str = "Neural Simulation",
                                    actions_list=None,
                                    generator: Optional[torch.Generator] = None):
    """Video of a beam of simulated futures with reward-masked frames
    (reference generate_planning_visualization, main.py:414-444):
    num_actions^lookahead rollouts; each frame dimmed where its rollout's
    cumulative reward dips below the mask threshold; the frames are then
    replayed in reverse.  Random plans come from ``generator`` (default:
    seeded with 0 on z's device)."""
    rollout_width = num_actions ** lookahead
    if actions_list is not None:
        actions = torch.as_tensor(actions_list, dtype=torch.int64,
                                  device=z.device)[None].repeat(rollout_width, 1)
    else:
        if generator is None:
            generator = torch.Generator(device=z.device).manual_seed(0)
        actions = torch.randint(0, num_actions, (rollout_width, rollout_depth),
                                generator=generator, device=generator.device).to(z.device)
    frames, cums, final_cum = _planning_rollout(params, z, actions, num_actions,
                                                rollout_depth)
    frames, cums = frames.cpu().numpy(), cums.cpu().numpy()
    collected = []
    caption = caption_title
    for t in range(frames.shape[0]):
        # the reference's rewards[:, 1] - rewards[:, 0] mask heuristic,
        # the summed signed reward where R < 2
        r = cums[t]
        score = (r[:, 1] - r[:, 0]) if r.shape[1] >= 2 else r[:, 0]
        mask = np.clip(score + 1.0, 0.0, 1.0)[:, None, None, None]
        best = float(np.max(score))
        img = (frames[t] * mask).mean(axis=0)
        caption = f"{caption_title} t+{t} R={best:.2f}"
        vid.write_frame(img, resize_to=(512, 512), caption=caption)
        collected.append(img)
    for img in collected[::-1]:
        vid.write_frame(img, resize_to=(512, 512), caption=caption_title)
    final = final_cum.cpu().numpy()
    score = (final[:, 1] - final[:, 0]) if final.shape[1] >= 2 else final[:, 0]
    print("Simulation {} reward: {:.2f}".format(
        int(np.argmax(score)), float(np.max(score))))


# --------------------------------------------------------------------------
# forward simulation video
# --------------------------------------------------------------------------

@torch.inference_mode()
def _simulation_rollout(params: WorldModel, obs, actions, num_actions: int):
    """Free-run from t = 2 replaying the real action sequence (reference
    main.py:706-716, 726-767) of the batch's first trajectory; returns the
    per-step decoded logits, reward vectors, reward maps and latents
    (before each step's transition), each stacked over t = 2..T-2."""
    transition_fn, decode_fn = serving_steps(params, num_actions)
    t_total = obs.shape[1]
    actions_oh = _onehot(actions, num_actions, obs.dtype)        # (B, T, A)
    z = encode(params.encoder, obs[:, :3])
    z = transition_fn(z, actions_oh[:, 1])
    outs = []
    for t in range(2, t_total - 1):
        logits = decode_fn(z).to(torch.float32)
        r, rmap = predict_reward(params.reward_predictor, z.to(torch.float32),
                                 visualize=True)
        outs.append((logits[0], r[0], rmap[0], z[0]))
        z = transition_fn(z, actions_oh[:, t])
    return tuple(torch.stack(x) for x in zip(*outs))


def visualize_forward_simulation(params: WorldModel, datasource,
                                 train_iter: int = 0, timesteps: int = 60,
                                 out_dir: str = ".",
                                 generator: Optional[torch.Generator] = None):
    """simulation_ftr_iter_{iter:06d} video: ground truth | predicted with
    reward overlay | factor grid, and the true against the estimated
    cumulative reward (reference main.py:698-775)."""
    start = time.time()
    obs, rewards, dones, actions = datasource.collect(1, timesteps, generator=generator)
    logits, rvecs, rmaps, zs = _simulation_rollout(
        params, obs, actions, datasource.binary_input_channels)
    preds = torch.sigmoid(logits).cpu().numpy()
    rvecs, rmaps = rvecs.cpu().numpy(), rmaps.cpu().numpy()
    zs = zs.to(torch.float32).cpu().numpy()
    obs_np, rew_np = obs[0].cpu().numpy(), rewards[0].cpu().numpy()
    dones_np = dones[0].cpu().numpy()

    vid = Video(os.path.join(out_dir, f"simulation_ftr_iter_{train_iter:06d}.mp4"),
                framerate=3)
    est_cum = np.zeros(rvecs.shape[-1])
    true_cum = np.zeros(rew_np.shape[-1])
    for i in range(preds.shape[0]):
        t = 2 + i
        est_cum += rvecs[i]
        true_cum += rew_np[t]
        overlay = reward_overlay(preds[i], rmaps[i])
        vid.write_frame(_hstack_panels(obs_np[t], overlay, factor_grid(zs[i])))
        if dones_np[t]:
            break
    path = vid.finish()
    print("True cumulative reward: {}".format(format_reward_vector(true_cum)))
    print("Estimated cumulative reward: {}".format(format_reward_vector(est_cum)))
    print("Finished trajectory simulation in {:.02f}s".format(time.time() - start))
    return path
