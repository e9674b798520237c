"""Prediction-error-vs-horizon measurement: the headline evaluation.

Port of ``scmgan_tpu/analysis/mse.py``, the reference's
``measure_prediction_mse`` protocol (reference main.py:784-893): encode three
frames once, free-run the transition in eval mode (hard-threshold latents),
and record per-step masked pixel-MSE and reward-MSE means and stddevs; the
artifacts are ``mse_{name}_iter_{iter:06d}.json`` and
``mse_stddev_{name}_iter_{iter:06d}.json`` (+ PNG plots on request).

The JAX package compiles the free-run into one ``lax.scan``; here it is a
Python loop whose steps stay on the device, with one copy to the host at the
end.  On the card every step goes through the two CUDA kernels: the
transition (threshold head) and the fused decoder, which equals ``decode``
by linearity, so the protocol is unchanged.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from scmgan_tpu_torch.models.world_model import (
    WorldModel,
    encode,
    predict_reward,
)
from scmgan_tpu_torch.ops.kernels.fused_decoder import (
    fused_decode,
    pack_decoder_weights,
)
from scmgan_tpu_torch.ops.kernels.fused_transition import (
    fused_transition,
    pack_transition_weights,
)
from scmgan_tpu_torch.utils.timeseries import sparkline


def serving_steps(model: WorldModel, num_actions: int):
    """(transition_fn, decode_fn) on weights packed once: ``(z, a) -> z``
    in eval mode and ``z -> logits``, the two kernels (on the CPU their
    plain versions, in the packed weights' dtype)."""
    latent = model.transition["conv6"]["w"].shape[-1]
    pt = pack_transition_weights(model.transition, latent, num_actions)
    pd = pack_decoder_weights(model.decoder, latent)
    return (lambda z, a: fused_transition(pt, z, a)), (lambda z: fused_decode(pd, z))


@torch.inference_mode()
def _free_run_stats(model: WorldModel, batch, num_actions: int,
                    transition_fn=None, decode_fn=None):
    """Free-run the batch; returns per-step (pixel mse, pixel std, reward mse,
    reward std, active count, latent variance) for t = 2..T-1, each a
    (T-2,) tensor on the batch's device.

    ``transition_fn``: ``(z, action_onehot) -> z`` override of the eval-mode
    transition (alternate serving engines under the same protocol);
    ``decode_fn``: ``z -> logits`` override of the decoder.  By default both
    are the kernels, with weights packed once here, outside the loop.
    """
    obs, rewards, dones, actions = batch
    b, t_total = obs.shape[0], obs.shape[1]
    f32 = torch.float32
    actions_oh = torch.nn.functional.one_hot(
        actions.long(), num_actions).to(obs.dtype)

    if transition_fn is None or decode_fn is None:
        kernel_transition, kernel_decode = serving_steps(model, num_actions)
        transition_fn = transition_fn or kernel_transition
        decode_fn = decode_fn or kernel_decode

    def masked_stats(diffs, active):
        # reference main.py:816-818: mean/std over the masked vector, then
        # rescaled by batch/|active|, with torch.std's ddof=1.
        n_active = torch.clamp(active.sum(), min=1.0)
        return (diffs.mean() * b / n_active,
                diffs.std(correction=1) * b / n_active)

    # Begin at state t=2: encode frames 0..2, advance once with action[1]
    # (reference main.py:796-799).
    z = encode(model.encoder, obs[:, :3])
    z = transition_fn(z, actions_oh[:, 1])
    active = torch.ones((b,), dtype=f32, device=obs.device)
    rows = []
    for t in range(2, t_total):
        active = active * (1.0 - dones[:, t].to(f32))
        predicted = torch.sigmoid(decode_fn(z).to(f32))
        expected = obs[:, t].to(f32)
        diffs = active * ((expected - predicted) ** 2).mean(dim=(1, 2, 3))
        mse_mean, mse_std = masked_stats(diffs, active)

        r_expected = rewards[:, t].to(f32).sum(dim=-1)
        r_predicted = predict_reward(model.reward_predictor,
                                     z.to(f32)).sum(dim=-1)
        r_diffs = active * (r_expected - r_predicted) ** 2
        r_mean, r_std = masked_stats(r_diffs, active)

        z = transition_fn(z, actions_oh[:, t])
        # Collapse telemetry: total per-factor variance of the carried latent
        # across batch and space; exactly zero means every trajectory carries
        # the same constant latent from this horizon on.
        z_var = z.to(f32).var(dim=(0, 1, 2), correction=0).sum()
        rows.append(torch.stack([mse_mean, mse_std, r_mean, r_std,
                                 active.sum(), z_var]))
    return tuple(torch.stack(rows, dim=1))


def measure_prediction_mse(
    model: WorldModel,
    datasource,
    train_iter: int = 0,
    timesteps: int = 100,
    batch_size: int = 100,
    use_training_set: bool = False,
    out_dir: str = ".",
    make_plots: bool = True,
    generator: Optional[torch.Generator] = None,
    transition_fn=None,
):
    """Returns (mse_losses, mse_stddevs, reward_losses, reward_stddevs) as
    Python lists after writing the reference's JSON (and, with
    ``make_plots``, PNG) artifacts, or None for a degenerate trajectory.
    ``generator`` draws the batch (default: the datasource's own)."""
    batch = datasource.collect(batch_size, timesteps, generator=generator,
                               training=use_training_set)
    mse_m, mse_s, rew_m, rew_s, n_active, z_var = (
        x.cpu().numpy()
        for x in _free_run_stats(model, batch,
                                 datasource.binary_input_channels,
                                 transition_fn=transition_fn))
    # The reference stops at the first step where every trajectory is done
    # (main.py:809-812); active counts never increase.
    alive = n_active > 0
    cut = int(np.argmax(~alive)) if (~alive).any() else len(alive)
    if cut == 0:
        print("Degenerate trajectory, skipping MSE calculation")
        return None
    mse_losses = mse_m[:cut].tolist()
    mse_stddevs = mse_s[:cut].tolist()
    reward_losses = rew_m[:cut].tolist()
    reward_stddevs = rew_s[:cut].tolist()

    collapsed = np.flatnonzero(z_var[:cut] == 0.0)
    if collapsed.size:
        print(
            "WARNING: eval-mode latent collapse at free-run step "
            f"{int(collapsed[0]) + 1}/{cut}: the carried latent is a "
            "batch-wide constant, so predictions are state-independent "
            "from that horizon on (flat MSE curve, degenerate planning).")

    print("MSE over {} timesteps: min {:.3f} max {:.3f}".format(
        timesteps, min(mse_losses), max(mse_losses)))
    print(sparkline(mse_losses, length=80))
    print("Avg. MSE loss: {}".format(np.mean(mse_losses)))
    print(sparkline(reward_losses, length=80))
    print("Avg. reward MSE loss: {}".format(np.mean(reward_losses)))

    plot_error_graph(mse_losses, mse_stddevs, "pixel", train_iter,
                     facecolor="#00FF00", edgecolor="#00FF00",
                     title="Prediction Error vs. Time (Pixel MSE)",
                     out_dir=out_dir, make_plot=make_plots)
    plot_error_graph(reward_losses, reward_stddevs, "reward", train_iter,
                     facecolor="#FFFF00", edgecolor="#FFFF00",
                     title="Prediction Error vs. Time (Reward)",
                     out_dir=out_dir, make_plot=make_plots)
    return mse_losses, mse_stddevs, reward_losses, reward_stddevs


def plot_error_graph(losses, stddevs, experiment_name: str, train_iter: int,
                     title: str = "", facecolor: str = "#00FF00",
                     edgecolor: str = "#00FF00", out_dir: str = ".",
                     make_plot: bool = True):
    """JSON (+ PNG) artifacts in the reference's exact naming scheme
    (main.py:858-882).  matplotlib is imported only for the PNG, which is
    left out where it does not import."""
    mse_filename = os.path.join(
        out_dir, f"mse_{experiment_name}_iter_{train_iter:06d}.json")
    with open(mse_filename, "w") as fp:
        fp.write(json.dumps(losses, indent=2))
    stddev_filename = os.path.join(
        out_dir, f"mse_stddev_{experiment_name}_iter_{train_iter:06d}.json")
    with open(stddev_filename, "w") as fp:
        fp.write(json.dumps(stddevs, indent=2))

    if not make_plot:
        return
    try:
        import matplotlib
    except ImportError:
        return

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    fig, ax = plt.subplots()
    x = np.arange(len(losses))
    mean = np.asarray(losses)
    err = np.asarray(stddevs)
    ax.plot(x, mean, color=edgecolor)
    ax.fill_between(x, mean - err, mean + err, alpha=0.2,
                    facecolor=facecolor, edgecolor=edgecolor)
    ax.set_title(f"Loss: {title}")
    ax.grid(True)
    ax.set_ylim(bottom=0)
    ax.set_ylabel("MSE")
    ax.set_xlabel("Prediction horizon (timesteps)")
    fig.savefig(os.path.join(
        out_dir, f"mse_{experiment_name}_iter_{train_iter:06d}.png"))
    plt.close(fig)
