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
functions.  The kernel computes the f32 epilogue only: the bf16 epilogue
(``epilogue_dtype=torch.bfloat16``, ``_qconv`` / ``_qepilogue`` of the JAX
module) runs in plain PyTorch on either device.

The JAX package's measured alternatives of the same step,
``transition_int8_halo`` / ``_split`` / ``_ring``, and the int8 decoder
(``quantize_decoder``, ``decode_int8``) are XLA code there and plain
PyTorch here: every int32 sum exactly, as an f64 conv (as the kernel's
plain version computes them), then the epilogue in the requested dtype.
With the f32 epilogue the three variants are bit-equal to
``transition_int8``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from scmgan_tpu_torch.models.world_model import transition as exact_transition
from scmgan_tpu_torch.ops.kernels.fused_transition import philox_uniform
from scmgan_tpu_torch.ops.conv import circular_pad
from scmgan_tpu_torch.ops.kernels.int8_transition import (
    ACT_SCALE,
    _action_bias,
    _qepilogue,
    _quantize,
    int8_transition,
    int_sums,
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

    with torch.no_grad():
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
    return fold_calibrated(params, act_scale, z_samples.shape[-1],
                           action_onehots.shape[-1])


def input_scales(act_scale: dict, latent_and_actions: int) -> dict:
    """Each conv's per-input-channel scale: 1 for conv1's binary latents and
    one-hot actions, the previous layer's output scale for the rest (the
    concatenated pair for the skip convs)."""
    return {
        "conv1": torch.ones((latent_and_actions,), dtype=torch.float32,
                            device=act_scale["conv1"].device),
        "conv2": act_scale["conv1"],
        "conv3": act_scale["conv2"],
        "conv4": act_scale["conv3"],
        "conv5": torch.cat([act_scale["conv4"], act_scale["conv2"]]),  # (h4, h2)
        "conv6": torch.cat([act_scale["conv5"], act_scale["conv1"]]),  # (h5, h1)
    }


def fold_calibrated(params: dict, act_scale: dict, latent: int,
                    num_actions: int) -> QuantizedTransition:
    """``calibrate_transition`` given the activation scales."""
    in_scales = input_scales(act_scale, latent + num_actions)
    weights, scales = {}, {}
    for name, w in _sn_folded(params).items():
        w_folded = w.to(torch.float32) * in_scales[name][None, None, :, None]
        weights[name], scales[name] = _quantize(w_folded)
    requant = {name: 1.0 / act_scale[name] for name in _CONVS[:5]}
    requant["conv6"] = torch.tensor(1.0, dtype=torch.float32)
    return make_quantized(weights, scales, _biases(params), requant)


# ---------------------------------------------------------------------------
# the plain int8 arithmetic: exact sums, the epilogue in f32 or bf16
# ---------------------------------------------------------------------------

def _epilogue(qt: QuantizedTransition, name: str, acc: torch.Tensor, *,
              requant: bool = True, epilogue_dtype=torch.float32,
              extra_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dequant + bias (+ leaky-ReLU + requant to int8) of conv ``name`` on
    exact sums (``_qepilogue`` of the JAX module).  ``extra_bias`` (B, Cout)
    adds conv1's action half to the sums.  The f32 epilogue rounds
    ``y * rq`` in f32, as the kernel does; the bf16 one casts the sums to
    bf16 and rounds every step, ``y * rq`` included, in bf16.  Without
    ``requant`` (conv6) returns the f32 logits."""
    if extra_bias is not None:
        acc = acc + extra_bias[:, None, None, :]
    scale, bias = qt.scales[name], qt.biases[name]
    rq = qt.requant[name]
    if epilogue_dtype == torch.float32:
        return _qepilogue(acc, scale.to(torch.float32), bias.to(torch.float32),
                          rq if requant else None)
    if epilogue_dtype != torch.bfloat16:
        raise ValueError(f"epilogue_dtype must be float32 or bfloat16, not {epilogue_dtype}")
    bf = torch.bfloat16
    # int32 -> bf16 through f32, as XLA converts (exact below 2^24)
    y = acc.to(torch.float32).to(bf) * scale.to(bf) + bias.to(bf)
    if not requant:
        return y.to(torch.float32)
    y = torch.where(y >= 0, y, torch.tensor(0.01, dtype=bf, device=y.device) * y)
    q = torch.round(y * rq.to(device=y.device, dtype=bf))
    return torch.clamp(q, -127, 127).to(torch.int8)


def _head(logits: torch.Tensor, u: Optional[torch.Tensor], sample: bool,
          via_sigmoid: bool) -> torch.Tensor:
    """The step's output bits as f32: Bernoulli(sigmoid) with uniforms ``u``
    (``u < p``, the port's stand-in for the key) when ``sample``; else the
    threshold, as ``sigmoid(logits) > 0.5`` or as ``logits > 0`` (the two
    differ where the sigmoid rounds to exactly 0.5)."""
    if sample and u is not None:
        return (u < torch.sigmoid(logits)).to(torch.float32)
    if via_sigmoid:
        return (torch.sigmoid(logits) > 0.5).to(torch.float32)
    return (logits > 0).to(torch.float32)


def _split_logits(qt: QuantizedTransition, z: torch.Tensor,
                  action_onehot: torch.Tensor, epilogue_dtype) -> torch.Tensor:
    """conv6's f32 logits through per-conv wrap-pads with concat-free skips
    (``transition_int8_split``): conv(concat(a, b), W) as conv(a, W_a) +
    conv(b, W_b) on the already wrap-padded h1 and h2, conv1's action half
    as a per-sample bias."""
    latent = z.shape[-1]
    w = qt.weights

    def epi(name, acc, **kw):
        return _epilogue(qt, name, acc, epilogue_dtype=epilogue_dtype, **kw)

    h1 = epi("conv1", int_sums(circular_pad(_binarize_latent(z)), w["conv1"][:, :, :latent]),
             extra_bias=_action_bias(qt.packed, action_onehot))
    h1p = circular_pad(h1)
    h2 = epi("conv2", int_sums(h1p, w["conv2"]))
    h2p = circular_pad(h2)
    h3 = epi("conv3", int_sums(h2p, w["conv3"]))
    h4 = epi("conv4", int_sums(circular_pad(h3), w["conv4"]))
    hid = w["conv5"].shape[-1]
    h5 = epi("conv5", int_sums(circular_pad(h4), w["conv5"][:, :, :hid])
             + int_sums(h2p, w["conv5"][:, :, hid:]))
    return epi("conv6", int_sums(circular_pad(h5), w["conv6"][:, :, :hid])
               + int_sums(h1p, w["conv6"][:, :, hid:]), requant=False)


def _plain_step(qt, z, action_onehot, sample, seed, epilogue_dtype, via_sigmoid):
    """The step with a bf16 epilogue (the kernel has none): its plain
    logits; the sample head draws the kernel's Philox stream keyed by
    ``seed``."""
    logits = _split_logits(qt, z, action_onehot, epilogue_dtype)
    u = None
    if sample:
        b, h, w, latent = z.shape
        pad = qt.packed["latent_pad"]
        u = torch.from_numpy(philox_uniform(seed, (b, h, w, pad))[..., :latent]
                             ).to(logits.device)
    return _head(logits, u, sample, via_sigmoid).to(z.dtype)


def transition_int8_v2(qt: QuantizedTransition, z: torch.Tensor,
                       action_onehot: torch.Tensor, *, sample: bool = False,
                       seed: int = 0, epilogue_dtype=torch.float32) -> torch.Tensor:
    """The serving step: conv1's action half as a rank-1 int32 bias, the
    threshold head as ``logits > 0``.  z: (B, H, W, latent) binary values
    (a float carry is thresholded at 0.5); returns latents in z's dtype.
    ``sample`` draws Bernoulli(sigmoid) bits from the Philox stream keyed by
    ``seed``.  The default f32 epilogue runs the int8 kernel on the card;
    ``epilogue_dtype=torch.bfloat16`` takes the plain route on any device
    (``_plain_step``): the kernel has no bf16 epilogue."""
    if epilogue_dtype != torch.float32:
        return _plain_step(qt, z, action_onehot, sample, seed, epilogue_dtype, False)
    out = int8_transition(qt.packed, _binarize_latent(z), action_onehot,
                          head="sample" if sample else "logit", seed=seed)
    return out.to(z.dtype)


def transition_int8(qt: QuantizedTransition, z: torch.Tensor,
                    action_onehot: torch.Tensor, *, sample: bool = False,
                    seed: int = 0, epilogue_dtype=torch.float32) -> torch.Tensor:
    """``transition_int8_v2`` with the threshold head as sigmoid > 0.5 (the
    two differ only for logits in (0, 1.2e-7)); the bf16 epilogue takes the
    plain route as there."""
    if epilogue_dtype != torch.float32:
        return _plain_step(qt, z, action_onehot, sample, seed, epilogue_dtype, True)
    out = int8_transition(qt.packed, _binarize_latent(z), action_onehot,
                          head="sample" if sample else "sigmoid", seed=seed)
    return out.to(z.dtype)


# ---------------------------------------------------------------------------
# the JAX package's measured alternatives of the step, in plain PyTorch
# ---------------------------------------------------------------------------

def transition_int8_halo(qt: QuantizedTransition, z: torch.Tensor,
                         action_onehot: torch.Tensor,
                         u: Optional[torch.Tensor] = None, *, sample: bool = False,
                         epilogue_dtype=torch.bfloat16) -> torch.Tensor:
    """The halo chain (``transition_int8_halo``): ONE wrap-pad of 6 feeds
    all six convs as a shrinking VALID chain (H + 12 -> H + 10 -> ... -> H),
    the U-Net concats become split-kernel sums with the skip tensors cropped
    by negative padding, and conv1's action half is a per-sample bias.
    Bit-equal to ``transition_int8`` with the f32 epilogue; its default
    epilogue is bf16, as the JAX function's.  Head: ``sigmoid > 0.5``, or
    ``u < sigmoid`` with ``sample`` and uniforms ``u`` (z's shape)."""
    latent = z.shape[-1]

    def epi(name, acc, **kw):
        return _epilogue(qt, name, acc, epilogue_dtype=epilogue_dtype, **kw)

    w = qt.weights
    zp = circular_pad(_binarize_latent(z), 6)
    h1 = epi("conv1", int_sums(zp, w["conv1"][:, :, :latent]),
             extra_bias=_action_bias(qt.packed, action_onehot))          # H + 10
    h2 = epi("conv2", int_sums(h1, w["conv2"]))                          # H + 8
    h3 = epi("conv3", int_sums(h2, w["conv3"]))                          # H + 6
    h4 = epi("conv4", int_sums(h3, w["conv4"]))                          # H + 4
    hid = w["conv5"].shape[-1]
    h5 = epi("conv5", int_sums(h4, w["conv5"][:, :, :hid])
             + int_sums(h2, w["conv5"][:, :, hid:], pad=-2))             # H + 2
    logits = epi("conv6", int_sums(h5, w["conv6"][:, :, :hid])
                 + int_sums(h1, w["conv6"][:, :, hid:], pad=-4), requant=False)
    return _head(logits, u, sample, True).to(z.dtype)


def transition_int8_split(qt: QuantizedTransition, z: torch.Tensor,
                          action_onehot: torch.Tensor,
                          u: Optional[torch.Tensor] = None, *, sample: bool = False,
                          epilogue_dtype=torch.float32) -> torch.Tensor:
    """Concat-free skips at the per-conv H x W shapes
    (``transition_int8_split``, ``_split_logits``).  Bit-equal to
    ``transition_int8`` with the f32 epilogue.  Head as
    ``transition_int8_halo``."""
    logits = _split_logits(qt, z, action_onehot, epilogue_dtype)
    return _head(logits, u, sample, True).to(z.dtype)


def _ring_qconv(qt: QuantizedTransition, name: str, x: torch.Tensor,
                w: Optional[torch.Tensor] = None, *, requant: bool = True,
                epilogue_dtype=torch.float32,
                extra_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A circular int8 conv with no wrap-padded copy (``_ring_qconv``): a
    SAME conv with zero padding, exact everywhere but the outer ring of
    outputs, then the four one-pixel border strips recomputed from 3-wide
    input slices wrapped on their own (both row strips as one batch, both
    column strips as another) and written over the ring; the corners are
    written by a row strip and then by a column strip, with equal values."""
    if w is None:
        w = qt.weights[name]
    b, h, wd, _ = x.shape

    def epi(acc, bias):
        return _epilogue(qt, name, acc, requant=requant,
                         epilogue_dtype=epilogue_dtype, extra_bias=bias)

    y = epi(int_sums(x, w, pad=1), extra_bias)
    strip_bias = None if extra_bias is None else torch.cat([extra_bias] * 2)
    # row strips: output rows {0, h-1}; input rows {h-1, 0, 1} / {h-2, h-1, 0}
    rows = torch.cat([torch.cat([x[:, h - 1:], x[:, :2]], 1),
                      torch.cat([x[:, h - 2:], x[:, :1]], 1)], 0)
    rows = torch.cat([rows[:, :, wd - 1:], rows, rows[:, :, :1]], 2)
    rows_out = epi(int_sums(rows, w), strip_bias)                 # (2B, 1, W, Co)
    # column strips: output columns {0, w-1}
    cols = torch.cat([torch.cat([x[:, :, wd - 1:], x[:, :, :2]], 2),
                      torch.cat([x[:, :, wd - 2:], x[:, :, :1]], 2)], 0)
    cols = torch.cat([cols[:, h - 1:], cols, cols[:, :1]], 1)
    cols_out = epi(int_sums(cols, w), strip_bias)                 # (2B, H, 1, Co)
    y = y.clone()
    y[:, :1] = rows_out[:b]
    y[:, h - 1:] = rows_out[b:]
    y[:, :, :1] = cols_out[:b]
    y[:, :, wd - 1:] = cols_out[b:]
    return y


def transition_int8_ring(qt: QuantizedTransition, z: torch.Tensor,
                         action_onehot: torch.Tensor,
                         u: Optional[torch.Tensor] = None, *, sample: bool = False,
                         epilogue_dtype=torch.float32) -> torch.Tensor:
    """The step through pad-free circular convs (``transition_int8_ring``,
    ``_ring_qconv``), conv1's action half as a per-sample bias.  Bit-equal
    to ``transition_int8`` with the f32 epilogue.  Head: ``logits > 0``, or
    ``u < sigmoid`` with ``sample`` and uniforms ``u``."""
    latent = z.shape[-1]

    def rc(name, t, w=None, **kw):
        return _ring_qconv(qt, name, t, w, epilogue_dtype=epilogue_dtype, **kw)

    h1 = rc("conv1", _binarize_latent(z), qt.weights["conv1"][:, :, :latent],
            extra_bias=_action_bias(qt.packed, action_onehot))
    h2 = rc("conv2", h1)
    h3 = rc("conv3", h2)
    h4 = rc("conv4", h3)
    h5 = rc("conv5", torch.cat([h4, h2], -1))
    logits = rc("conv6", torch.cat([h5, h1], -1), requant=False)
    return _head(logits, u, sample, False).to(z.dtype)


# ---------------------------------------------------------------------------
# the int8 decoder
# ---------------------------------------------------------------------------

class QuantizedDecoder(NamedTuple):
    """The quantized serving decoder (``QuantizedDecoder`` of the JAX
    module): two stride-1 transposed convs as SAME convs with flipped
    kernels, then the per-factor sum.  Binary latents are exactly int8."""

    w1: torch.Tensor   # int8 HWIO (flipped) kernel, latent -> 4 * latent
    w2: torch.Tensor   # int8 HWIO (flipped) kernel, 4 * latent -> latent * color
    s1: torch.Tensor   # f32 (4L,) conv1 dequant scale
    s2: torch.Tensor   # f32 (L * color,) conv2 dequant scale, ACT_SCALE folded in
    b1: torch.Tensor   # f32 (4L,)
    b2: torch.Tensor   # f32 (L * color,)


def _act_scale(device) -> torch.Tensor:
    return torch.tensor(ACT_SCALE, dtype=torch.float32, device=device)


def quantize_decoder(params: dict) -> QuantizedDecoder:
    """Per-output-channel int8 of the decoder's kernels, flipped in H and W
    (``quantize_decoder`` of the JAX module)."""
    q1, s1 = _quantize(params["conv1"]["w"].flip(0, 1))
    q2, s2 = _quantize(params["conv2"]["w"].flip(0, 1))
    return QuantizedDecoder(q1, q2, s1, s2 * _act_scale(s2.device),
                            params["conv1"]["b"].to(torch.float32),
                            params["conv2"]["b"].to(torch.float32))


def decode_int8(qd: QuantizedDecoder, z_i8: torch.Tensor) -> torch.Tensor:
    """The int8 decoder: z (B, H, W, L) binary int8 -> pixel logits (B, H, W,
    color), f32 (``decode_int8`` of the JAX module).  Both convs are SAME
    with zero padding; the hidden leaky-ReLU layer is requantized by
    division by the static ``ACT_SCALE`` (as the JAX function divides); the
    per-factor sum comes last, factor by factor in order (the order XLA's
    CPU reduction sums in, so the logits are bit-equal to the JAX
    function's there).  Plain PyTorch on any device; lossy (serving only)."""
    f32 = torch.float32
    h = int_sums(z_i8, qd.w1, pad=1).to(f32) * qd.s1 + qd.b1
    h = torch.where(h >= 0, h, 0.01 * h)
    h_q = torch.clamp(torch.round(h / _act_scale(h.device)), -127, 127).to(torch.int8)
    x = int_sums(h_q, qd.w2, pad=1).to(f32) * qd.s2 + qd.b2
    b, hh, ww, _ = x.shape
    latent = z_i8.shape[-1]
    x = x.reshape(b, hh, ww, latent, x.shape[-1] // latent)
    out = x[..., 0, :]
    for i in range(1, latent):
        out = out + x[..., i, :]
    return out
