"""The int8 (w8a8) serving transition: quantization and the step.

Port of ``scmgan_tpu/models/quantized.py``: per-output-channel symmetric
int8 weights with spectral norm folded in, int8 activations with a static
(``quantize_transition``) or calibrated per-channel (``calibrate_transition``)
scale, int32 sums, and an f32 dequant + bias + leaky-ReLU + requant epilogue.
Lossy by design: serving only (the free-run fidelity gate, rollouts).

The step, ``transition_int8`` / ``transition_int8_v2``, runs on the card as
the hand-written kernel of ``ops/kernels/int8_transition.py`` (which holds
the epilogue ``_qepilogue`` and the action bias ``_action_bias`` beside its
plain version); on the CPU it is that plain version, bit-equal to the JAX
functions.  The JAX package's halo / ring / split variants, its bf16
epilogue option and the int8 decoder are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scmgan_tpu_torch.models.world_model import transition as exact_transition
from scmgan_tpu_torch.ops.kernels.int8_transition import (
    ACT_SCALE,
    _quantize,
    int8_transition,
    pack_operands,
)
from scmgan_tpu_torch.ops.spectral_norm import sn_weight

_CONVS = ("conv1", "conv2", "conv3", "conv4", "conv5", "conv6")


class QuantizedTransition(NamedTuple):
    """Quantized transition weights, with the kernel's operands packed once
    from them (``make_quantized``)."""

    weights: dict     # name -> int8 HWIO kernel
    scales: dict      # name -> f32 (Cout,) folded (w_scale * in_scale)
    biases: dict      # name -> f32 (Cout,)
    requant: dict     # name -> f32 (Cout,) or scalar: 1 / output act scale
    packed: dict      # ops/kernels/int8_transition.py::pack_operands


def make_quantized(weights: dict, scales: dict, biases: dict,
                   requant: dict) -> QuantizedTransition:
    """A QuantizedTransition with its kernel operands (joint conv5/conv6)."""
    return QuantizedTransition(weights, scales, biases, requant,
                               pack_operands(weights, scales, biases, requant))


def _binarize_latent(z: torch.Tensor) -> torch.Tensor:
    """Latents enter the int8 engine as {0,1}.  A float carry straight off
    the encoder holds continuous sigmoid values; a cast to int8 would
    truncate them all to 0 (the JAX package measured a free-run that
    diverges to a constant frame, 23x MSE at t+10), so threshold at 0.5
    instead.  Integer carries pass through."""
    if z.is_floating_point():
        return (z > 0.5).to(torch.int8)
    return z.to(torch.int8)


def _sn_folded(params: dict) -> dict:
    """Each conv's weight with spectral norm folded in (conv6 has none)."""
    out = {name: sn_weight(params[name]) for name in _CONVS[:5]}
    out["conv6"] = params["conv6"]["w"]
    return out


def _biases(params: dict) -> dict:
    return {name: params[name]["b"].to(torch.float32) for name in _CONVS}


def quantize_transition(params: dict) -> QuantizedTransition:
    """Static-scale quantization (activations assumed in [0, 8]).  For
    trained models ``calibrate_transition`` is the better serving choice
    (the JAX package measured 13-14% worse free-run MSE@10 with static
    scales on trained pong and minipacman)."""
    weights, scales = {}, {}
    for name, w in _sn_folded(params).items():
        weights[name], ws = _quantize(w)
        scales[name] = ws * (1.0 if name == "conv1" else ACT_SCALE)
    requant = {name: torch.tensor(1.0 / ACT_SCALE, dtype=torch.float32)
               for name in _CONVS}
    return make_quantized(weights, scales, _biases(params), requant)


def percentile_rows(x: torch.Tensor, percentile: float) -> torch.Tensor:
    """``jnp.percentile(x, percentile, axis=0)`` (linear interpolation) of
    f32 ``x`` in the f32 steps XLA compiles it to: q = percentile * f32(0.01)
    (XLA multiplies by the reciprocal of the constant 100), the position
    p = q (n - 1), w = p - floor(p), then low (1 - w) + high w contracted
    into one FMA (here: the exact first product plus the rounded second,
    rounded once).  ``torch.quantile`` rounds the position otherwise and
    lands up to 5e-6 relative away at percentile 99."""
    n = x.shape[0]
    f32 = torch.float32
    s = torch.sort(x.to(f32), dim=0).values
    q = torch.tensor(percentile, dtype=f32) * torch.tensor(0.01, dtype=f32)
    pos = q * torch.tensor(n - 1, dtype=f32)
    low, high = torch.floor(pos), torch.ceil(pos)
    w = pos - low
    lo = s[int(low.clamp(0, n - 1))]
    hi = s[int(high.clamp(0, n - 1))]
    f64 = torch.float64
    return (lo.to(f64) * (1 - w).to(f64) + (hi * w).to(f64)).to(f32)


def activation_scales(params: dict, z_samples: torch.Tensor,
                      action_onehots: torch.Tensor,
                      percentile: float = 100.0) -> dict:
    """Per-channel scales of the transition's five hidden leaky-ReLU
    outputs, measured on an exact f32 forward: one step for
    ``action_onehots`` of shape (N, A), or a T-step exact free-run from
    ``z_samples`` (hard-thresholded carry) for shape (N, T, A).  The range is
    the per-channel max of |activation| over batch, space and steps, or its
    ``percentile`` when that is below 100."""
    p32 = {name: {k: (v.to(torch.float32) if torch.is_tensor(v) else
                      {kk: vv.to(torch.float32) for kk, vv in v.items()})
                  for k, v in params[name].items()} for name in _CONVS}

    def chan_range(x):
        flat = x.reshape(-1, x.shape[-1]).abs()
        if percentile >= 100.0:
            return flat.amax(dim=0)
        return percentile_rows(flat, percentile)

    with torch.inference_mode():
        z = z_samples.to(torch.float32)
        a = action_onehots.to(torch.float32)
        if a.ndim == 3:
            ranges = None
            for t in range(a.shape[1]):
                *hs, z = exact_transition(p32, z, a[:, t], return_all=True)
                step = [chan_range(h) for h in hs]
                ranges = step if ranges is None else [
                    torch.maximum(r, s) for r, s in zip(ranges, step)]
        else:
            *hs, _ = exact_transition(p32, z, a, return_all=True)
            ranges = [chan_range(h) for h in hs]
    return {name: torch.clamp(r, min=1e-4) / 127.0
            for name, r in zip(_CONVS[:5], ranges)}


def calibrate_transition(params: dict, z_samples: torch.Tensor,
                         action_onehots: torch.Tensor,
                         percentile: float = 100.0) -> QuantizedTransition:
    """Calibrated per-channel w8a8 quantization of the transition.

    Runs ``activation_scales`` on the calibration batch (prefer the
    multi-step form, (N, T, A): ranges measured only at the seed states
    under-cover the states a free-run visits), folds each layer's
    per-input-channel scale into its weights, quantizes per output channel,
    and requantizes each hidden layer by its own per-channel output scale;
    conv6's logits are never requantized.
    """
    act_scale = activation_scales(params, z_samples, action_onehots,
                                  percentile=percentile)
    return _fold_calibrated(params, act_scale, z_samples.shape[-1],
                            action_onehots.shape[-1])


def _fold_calibrated(params: dict, act_scale: dict, latent: int,
                     num_actions: int) -> QuantizedTransition:
    """``calibrate_transition`` given the activation scales."""
    dev = act_scale["conv1"].device
    in_scales = {
        "conv1": torch.ones((latent + num_actions,), dtype=torch.float32,
                            device=dev),
        "conv2": act_scale["conv1"],
        "conv3": act_scale["conv2"],
        "conv4": act_scale["conv3"],
        "conv5": torch.cat([act_scale["conv4"], act_scale["conv2"]]),  # (h4, h2)
        "conv6": torch.cat([act_scale["conv5"], act_scale["conv1"]]),  # (h5, h1)
    }
    weights, scales = {}, {}
    for name, w in _sn_folded(params).items():
        w_folded = w.to(torch.float32) * in_scales[name][None, None, :, None]
        weights[name], scales[name] = _quantize(w_folded)
    requant = {name: 1.0 / act_scale[name] for name in _CONVS[:5]}
    requant["conv6"] = torch.tensor(1.0, dtype=torch.float32)
    return make_quantized(weights, scales, _biases(params), requant)


def transition_int8_v2(qt: QuantizedTransition, z: torch.Tensor,
                       action_onehot: torch.Tensor, *, sample: bool = False,
                       seed: int = 0) -> torch.Tensor:
    """The serving step: conv1's action half as a rank-1 int32 bias, the
    threshold head as ``logits > 0``.  z: (B, H, W, latent) binary values
    (a float carry is thresholded at 0.5); returns latents in z's dtype.
    ``sample`` draws Bernoulli(sigmoid) bits from the Philox stream keyed by
    ``seed``."""
    out = int8_transition(qt.packed, _binarize_latent(z), action_onehot,
                          head="sample" if sample else "logit", seed=seed)
    return out.to(z.dtype)


def transition_int8(qt: QuantizedTransition, z: torch.Tensor,
                    action_onehot: torch.Tensor, *, sample: bool = False,
                    seed: int = 0) -> torch.Tensor:
    """``transition_int8_v2`` with the threshold head as sigmoid > 0.5 (the
    two differ only for logits in (0, 1.2e-7))."""
    out = int8_transition(qt.packed, _binarize_latent(z), action_onehot,
                          head="sample" if sample else "sigmoid", seed=seed)
    return out.to(z.dtype)
