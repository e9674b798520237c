"""The int8 (w8a8) transition step as a hand-written CUDA kernel, and its
plain version.

One kernel, ``csrc/int8_transition.cu``, takes the place of both Pallas int8
transitions and of the XLA int8 serving path:

- ``scmgan_tpu/ops/pallas/quantized_transition.py`` (``quantized_transition``,
  ``pack_quantized_weights``): static scales, conv5/conv6 quantized as two
  halves (main, skip), epilogue ``(pa*sa + pb*sb) + b``;
- ``scmgan_tpu/ops/pallas/int8_kernel.py`` (``int8_fused_transition``,
  ``pack_int8_weights``): the same weights, epilogue ``(pa*sa + b) + pb*sb``;
- ``scmgan_tpu/models/quantized.py`` (``transition_int8``,
  ``transition_int8_v2``): static or calibrated scales, conv5/conv6
  quantized whole, epilogue ``acc*s + b`` ("joint").

``pack_operands`` turns per-conv int8 weights and their scales into the
kernel's operands, once per model; ``int8_transition`` runs one step on them
(``csrc/int8_transition.cu`` with ``csrc/int8_conv.cuh``: six launches of an
implicit-GEMM circular 3x3 conv on s8 ``wgmma``).
``int8_transition_plain`` is the same function in PyTorch: each conv's int32
sums exactly, as an f64 conv (every |sum| < 2^53; f32 is exact only below
2^24, and PyTorch has no int8 conv on CUDA), then the same unfused f32
epilogue.  It is bit-equal to the JAX functions on the same operands.

conv1's one-hot action half is, as in ``transition_int8_v2``, a per-sample
int32 bias (``_action_bias``): the conv of a spatially constant one-hot map
is a sum over taps, so the int32 sums are those of the full conv for every
entry point.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scmgan_tpu_torch.ops.conv import circular_pad
from scmgan_tpu_torch.ops.kernels import _build
from scmgan_tpu_torch.ops.kernels.fused_transition import (
    kernel_hidden,
    pad_hidden,
    philox_uniform,
    round_up,
    tile_plan,
)
from scmgan_tpu_torch.ops.spectral_norm import sn_weight

ACT_SCALE = 8.0 / 127.0   # static scale: leaky-ReLU activations in [0, 8]

# The kernel's K plan: K runs over (tap, 16-channel unit) of each K segment,
# two units a k32 wgmma step, four steps (128 bytes) a weight tile; a
# segment is an input tensor, or 128 channels of a wider one (one 128-byte
# slot a pixel in shared memory), and starts a new tile.  The output runs in
# N tiles as the bf16 kernel's (``fused_transition.n_tiles``), the head's
# 16 wide, at the model's width padded to the next multiple of 16.
# Split-order convs at N >= 80 run on 128-pixel tiles.
UNIT = 16
STEP_UNITS = 2
TILE_UNITS = 8
MAX_SEGMENT = 128
LATENT_TILE = 16
SPLIT_TILE_M = 128
ORDERS = {"joint": 0, "sum_first": 1, "bias_first": 2}
HEADS = {"logit": 1, "sigmoid": 2, "sample": 3}   # conv6's; 0 is the hidden layers' requant


def _quantize(w: torch.Tensor):
    """Symmetric per-output-channel int8 (``models/quantized.py::_quantize``,
    the same as ``quantized_transition.py::_quantize_weight``):
    w (..., Cout) -> (int8 codes of w's shape, f32 (Cout,) scale)."""
    co = w.shape[-1]
    m = w.reshape(-1, co).to(torch.float32)
    scale = m.abs().amax(dim=0) / 127.0 + 1e-12
    q = torch.clamp(torch.round(m / scale), -127, 127).to(torch.int8)
    return q.reshape(w.shape), scale


def k_segments(segments) -> list:
    """The K segments of input tensors of ``segments`` channels
    (concatenated along Cin), in the kernel's order: ``(tensor, first
    channel, channels)`` each, a tensor in segments of MAX_SEGMENT channels
    and the rest.  Mirrors ``seg_of`` in ``csrc/int8_conv.cuh``."""
    out = []
    for t, c in enumerate(segments):
        if c % UNIT or c < UNIT:
            raise ValueError(f"a segment takes a positive multiple of {UNIT} channels; "
                             f"got {c}")
        out += [(t, off, min(MAX_SEGMENT, c - off)) for off in range(0, c, MAX_SEGMENT)]
    return out


def k_plan(segments) -> list:
    """The kernel's K order for input tensors of ``segments`` channels
    (concatenated along Cin): one entry per 16-byte K slot, ``(tensor, tap,
    unit)`` (the unit's index in its tensor) or None for zero padding.
    Within a K segment (``k_segments``) the units run tap by tap, unit by
    unit, two to a k32 step (so a step may span two taps); each segment is
    padded to whole weight tiles, so no step mixes two segments."""
    plan = []
    for t, off, c in k_segments(segments):
        units = [(t, tap, (off + j * UNIT) // UNIT) for tap in range(9)
                 for j in range(c // UNIT)]
        plan += units + [None] * (round_up(len(units), TILE_UNITS) - len(units))
    return plan


def pack_kernel_weights(w9: torch.Tensor, segments) -> torch.Tensor:
    """(9, Cin, Cout) int8 -> the kernel's layout, (tiles, Cout, 128) int8:
    tile t, row n holds output channel n's weights for K slots 8t .. 8t + 7
    of ``k_plan(segments)``, 16 bytes (input channels) a slot, zero for
    padding.  Each row is K-major, the wgmma B operand; one TMA box loads a
    tile with the 128-byte swizzle."""
    _, cin, cout = w9.shape
    if sum(segments) != cin:
        raise ValueError(f"segments {segments} do not add up to {cin} channels")
    offsets = [sum(segments[:i]) for i in range(len(segments))]
    plan = k_plan(segments)
    m = w9.new_zeros((len(plan), cout, UNIT))
    for k, slot in enumerate(plan):
        if slot is not None:
            seg, tap, j = slot
            c = offsets[seg] + j * UNIT
            m[k] = w9[tap, c:c + UNIT, :].T
    return (m.reshape(-1, TILE_UNITS, cout, UNIT).transpose(1, 2)
            .reshape(-1, cout, TILE_UNITS * UNIT).contiguous())


def pack_operands(weights: dict, scales: dict, biases: dict, requant: dict,
                  *, order: str = "joint") -> dict:
    """Kernel operands from per-conv int8 HWIO weights (conv1's input axis:
    latent, then the one-hot actions, then any zero padding).

    ``scales`` maps each conv to its f32 (Cout,) dequant scale; for the
    split orders conv5 and conv6 map to a pair (main half, skip half).
    ``requant`` maps conv1-conv5 to a scalar or (Cout,) multiplier.

    ``w`` and ``hidden`` stay at the model's width, for the plain version.
    The kernel's operands (``kw``, and conv1-5's ``s``, ``b``, ``rq`` and
    ``w1a``) are at the width rounded up to 16: an extra channel has zero
    weights, scale, bias and requant, so it requantizes to 0, and the next
    conv's weights for it are zero, so the step is the same function.
    """
    if order not in ORDERS:
        raise ValueError(f"order must be one of {sorted(ORDERS)}, not {order!r}")
    latent = biases["conv6"].shape[0]
    hidden = weights["conv2"].shape[-1]
    hp = kernel_hidden(hidden)
    num_actions = weights["conv1"].shape[2] - latent
    latent_pad = round_up(latent, LATENT_TILE)
    f32 = torch.float32

    def mat(name, cout_pad=None):
        w = weights[name]
        w = w.reshape(9, *w.shape[2:])
        if cout_pad is not None:
            w = torch.cat([w, w.new_zeros((*w.shape[:2], cout_pad - w.shape[2]))], -1)
        return w.contiguous()

    def vec(x, n):
        return torch.as_tensor(x, dtype=f32, device=biases["conv6"].device) \
            .expand(n).contiguous()

    def hvec(x):
        """A conv1-5 operand at the kernel's width."""
        return F.pad(vec(x, hidden), (0, hp - hidden))

    def pad_out(x):
        return torch.cat([x.to(f32), x.new_zeros(latent_pad - latent, dtype=f32)])

    w1 = mat("conv1")
    w = [w1[:, :latent].contiguous()] + [mat(f"conv{i}") for i in (2, 3, 4, 5)] \
        + [mat("conv6", latent_pad)]
    s = [hvec(scales[f"conv{i}"]) for i in range(1, 5)]
    if order == "joint":
        s += [hvec(scales["conv5"]), pad_out(scales["conv6"])]
    else:
        s += [tuple(hvec(x) for x in scales["conv5"]),
              tuple(pad_out(x) for x in scales["conv6"])]
    kw = ([pack_kernel_weights(pad_hidden(w[0], (latent,), latent_pad, hp), (latent_pad,))]
          + [pack_kernel_weights(pad_hidden(x, (hidden,), hp, hp), (hp,)) for x in w[1:4]]
          + [pack_kernel_weights(pad_hidden(w[4], (hidden, hidden), hp, hp), (hp, hp)),
             pack_kernel_weights(pad_hidden(w[5], (hidden, hidden), hp, latent_pad),
                                 (hp, hp))])
    return {
        "order": order, "latent_dim": latent, "num_actions": num_actions,
        "hidden": hidden, "latent_pad": latent_pad,
        "w": w,
        # conv1's action half summed over the taps: (actions, hp) int32
        "w1a": F.pad(w1[:, latent:latent + num_actions].sum(0, dtype=torch.int32),
                     (0, hp - hidden)),
        "kw": kw,
        "s": s,
        "b": [hvec(biases[f"conv{i}"]) for i in range(1, 6)]
             + [pad_out(biases["conv6"])],
        "rq": [hvec(requant[f"conv{i}"]) for i in range(1, 6)],
    }


def _pack_split(params: dict, order: str) -> dict:
    """Both Pallas packers' quantization: static scales, conv5/conv6 in two
    separately quantized halves."""
    w5 = sn_weight(params["conv5"])
    hidden = w5.shape[-2] // 2
    w6 = params["conv6"]["w"]
    weights, scales = {}, {}
    for name, w, in_scale in [("conv1", sn_weight(params["conv1"]), 1.0),
                              ("conv2", sn_weight(params["conv2"]), ACT_SCALE),
                              ("conv3", sn_weight(params["conv3"]), ACT_SCALE),
                              ("conv4", sn_weight(params["conv4"]), ACT_SCALE)]:
        weights[name], ws = _quantize(w)
        scales[name] = ws * in_scale
    for name, w in [("conv5", w5), ("conv6", w6)]:
        (qa, sa), (qb, sb) = _quantize(w[:, :, :hidden]), _quantize(w[:, :, hidden:])
        weights[name] = torch.cat([qa, qb], dim=2)
        scales[name] = (sa * ACT_SCALE, sb * ACT_SCALE)
    biases = {f"conv{i}": params[f"conv{i}"]["b"] for i in range(1, 7)}
    requant = {f"conv{i}": 1.0 / ACT_SCALE for i in range(1, 6)}
    return pack_operands(weights, scales, biases, requant, order=order)


def pack_quantized_weights(params: dict) -> dict:
    """Operands of ``quantized_transition`` (``quantized_transition.py:52``):
    static scales, split halves, ``(pa*sa + pb*sb) + b``.  The latent and
    action counts come from the weights' shapes."""
    return _pack_split(params, "sum_first")


def pack_int8_weights(params: dict) -> dict:
    """Operands of ``int8_fused_transition`` (``int8_kernel.py:44``): the
    same quantization, ``(pa*sa + b) + pb*sb``."""
    return _pack_split(params, "bias_first")


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

def int_sums(x: torch.Tensor, w: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """Exact int32 sums of the conv of integer-valued x (B, H, W, Cin) with an
    int8 HWIO kernel, held in f64 (every |sum| < 2^53): VALID after a zero
    pad of ``pad`` on each side; a negative ``pad`` crops the input instead
    (the JAX module's ``_vconv``)."""
    if pad < 0:
        x = x[:, -pad:x.shape[1] + pad, -pad:x.shape[2] + pad]
        pad = 0
    return F.conv2d(x.to(torch.float64).permute(0, 3, 1, 2),
                    w.to(torch.float64).permute(3, 2, 0, 1),
                    padding=pad).permute(0, 2, 3, 1)


def _int_conv(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of the circular 3x3 conv of int8 x (B, H, W, Cin)
    with int8 w9 (9, Cin, Cout), held in f64."""
    return int_sums(circular_pad(x, 1), w9.reshape(3, 3, *w9.shape[1:]))


def _action_bias(packed: dict, action_onehot: torch.Tensor) -> torch.Tensor:
    """conv1's action half as a per-sample (B, hidden) bias of exact int32
    sums, in f64 (``models/quantized.py::_action_bias``)."""
    a = action_onehot.to(torch.int32).to(torch.float64)
    w1a = packed["w1a"][:, :packed["hidden"]]
    return a @ w1a.to(device=a.device, dtype=torch.float64)


def _at_width(operands: list, n: int) -> list:
    """conv1-5's per-channel operands (each a tensor or a split pair) cut
    to the model's width ``n``; conv6's as they are."""
    def cut(x):
        return tuple(v[:n] for v in x) if isinstance(x, tuple) else x[:n]
    return [cut(x) for x in operands[:5]] + operands[5:]


def _qepilogue(acc, scale, bias, requant=None, *, order: str = "joint"):
    """Dequant + bias (+ leaky-ReLU + requant to int8 when ``requant`` is
    given) on exact sums, each step rounded to f32 as the references do
    (``models/quantized.py::_qepilogue``).  Split orders take ``acc`` and
    ``scale`` as (main, skip) pairs."""
    f32 = torch.float32
    if order == "joint":
        y = acc.to(f32) * scale + bias
    else:
        ya, yb = acc[0].to(f32) * scale[0], acc[1].to(f32) * scale[1]
        y = (ya + yb) + bias if order == "sum_first" else (ya + bias) + yb
    if requant is None:
        return y
    y = torch.where(y >= 0, y, 0.01 * y)
    return torch.clamp(torch.round(y * requant), -127, 127).to(torch.int8)


def int8_transition_logits(packed: dict, z: torch.Tensor,
                           action_onehot: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic up to conv6's f32 logits (B, H, W,
    latent_pad), in PyTorch.  z: (B, H, W, latent) int8 in {0, 1}."""
    order, hidden = packed["order"], packed["hidden"]
    w = packed["w"]
    s, b, rq = (_at_width(packed[k], hidden) for k in ("s", "b", "rq"))
    acc1 = _int_conv(z, w[0]) + _action_bias(packed, action_onehot)[:, None, None, :]
    h1 = _qepilogue(acc1, s[0], b[0], rq[0])
    h2 = _qepilogue(_int_conv(h1, w[1]), s[1], b[1], rq[1])
    h3 = _qepilogue(_int_conv(h2, w[2]), s[2], b[2], rq[2])
    h4 = _qepilogue(_int_conv(h3, w[3]), s[3], b[3], rq[3])

    def skip_conv(i, main, skip):
        if order == "joint":
            return _int_conv(torch.cat([main, skip], -1), w[i])
        return (_int_conv(main, w[i][:, :hidden]), _int_conv(skip, w[i][:, hidden:]))

    h5 = _qepilogue(skip_conv(4, h4, h2), s[4], b[4], rq[4], order=order)
    return _qepilogue(skip_conv(5, h5, h1), s[5], b[5], order=order)


def int8_transition_plain(packed: dict, z: torch.Tensor,
                          action_onehot: torch.Tensor, *, head: str = "logit",
                          u=None) -> torch.Tensor:
    """The kernel's function in PyTorch.  z: (B, H, W, latent) int8 in
    {0, 1}.  ``head``: "logit" (logits > 0), "sigmoid" (sigmoid > 0.5), or
    "sample" (u < sigmoid, with ``u`` of shape (B, H, W, latent_pad)).
    Returns int8 latents (B, H, W, latent)."""
    logits = int8_transition_logits(packed, z, action_onehot)
    if head == "logit":
        bits = logits > 0
    elif head == "sigmoid":
        bits = torch.sigmoid(logits) > 0.5
    elif head == "sample":
        bits = u < torch.sigmoid(logits)
    else:
        raise ValueError(f"head must be logit, sigmoid or sample, not {head!r}")
    return bits[..., :z.shape[-1]].to(torch.int8)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _operand_tensors(packed: dict):
    for key in ("kw", "s", "b", "rq"):
        for x in packed[key]:
            yield from (x if isinstance(x, tuple) else (x,))
    yield packed["w1a"]


def int8_transition(packed: dict, z: torch.Tensor,
                    action_onehot: torch.Tensor, *, head: str = "logit",
                    seed: int = 0) -> torch.Tensor:
    """One int8 transition step.  z: (B, H, W, latent) int8 in {0, 1};
    action_onehot: (B, A); any latent and hidden width and any number of
    actions.  Returns int8 latents (B, H, W, latent); the
    "sample" head draws from the Philox stream keyed by ``seed``
    (``fused_transition.philox_uniform``).

    A CUDA tensor launches the kernel (six convs); a CPU tensor takes
    ``int8_transition_plain``.
    """
    b, h, w, latent = z.shape
    shape_u = (b, h, w, packed["latent_pad"])
    if head not in HEADS:
        raise ValueError(f"head must be logit, sigmoid or sample, not {head!r}")
    if z.device.type == "cpu":
        u = (torch.from_numpy(philox_uniform(seed, shape_u))
             if head == "sample" else None)
        return int8_transition_plain(packed, z, action_onehot, head=head, u=u)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    num_actions = packed["num_actions"]
    if (z.dtype != torch.int8 or latent != packed["latent_dim"]
            or action_onehot.shape != (b, num_actions)):
        raise ValueError("z must be int8 and z / action shapes must match the "
                         "packed weights")
    hidden = kernel_hidden(packed["hidden"])
    for t in _operand_tensors(packed):
        if t.device != z.device or not t.is_contiguous():
            raise ValueError("packed operands must be contiguous on z's device")
    # conv1 reads latent_pad channels: the latents, then zeros
    if latent == packed["latent_pad"]:
        zp = z.contiguous()
    else:
        zp = torch.zeros(shape_u, dtype=torch.int8, device=z.device)
        zp[..., :latent] = z
    a = action_onehot.to(device=z.device, dtype=torch.float32).contiguous()
    act = torch.empty((4, b, h, w, hidden), dtype=torch.int8, device=z.device)
    out = torch.empty(shape_u, dtype=torch.int8, device=z.device)
    # split orders: conv5/conv6 carry (main, skip) scale pairs
    s = [x[0] if isinstance(x, tuple) else x for x in packed["s"]]
    s_skip = [x[1].data_ptr() if isinstance(x, tuple) else None
              for x in packed["s"][4:]]
    plans = [tile_plan(h, w), tile_plan(h, w, SPLIT_TILE_M)]
    lib = _build.library()
    rc = lib.scm_int8_step(
        zp.data_ptr(), a.data_ptr(), packed["w1a"].data_ptr(),
        *(t.data_ptr() for t in packed["kw"]), *(t.data_ptr() for t in s),
        *s_skip, *(t.data_ptr() for t in packed["b"]),
        *(t.data_ptr() for t in packed["rq"]),
        *(t.data_ptr() for t in act), out.data_ptr(),
        b, h, w, hidden, packed["latent_pad"], num_actions, ORDERS[packed["order"]],
        HEADS[head],
        *(p[k] for p in plans
          for k in ("tw", "tws", "rows", "row_blocks", "col_blocks")),
        seed, torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "int8_transition")
    int8_transition.launches += 1
    return out[..., :latent]


# Calls that launched the kernel (one call = one transition step = six conv
# launches); the CPU path does not count.
int8_transition.launches = 0


# ---------------------------------------------------------------------------
# the Pallas kernels' entry points
# ---------------------------------------------------------------------------

def quantized_transition(params: dict, z: torch.Tensor,
                         action_onehot: torch.Tensor, *, sample: bool = False,
                         seed: int = 0) -> torch.Tensor:
    """Drop-in int8 serving transition with the operands of
    ``quantized_transition.py:209``.  z: (B, H, W, latent) binary values;
    returns binary latents in z's dtype."""
    packed = pack_quantized_weights(params)
    out = int8_transition(packed, z.to(torch.int8), action_onehot,
                          head="sample" if sample else "sigmoid", seed=seed)
    return out.to(z.dtype)


def int8_fused_transition(params: dict, z: torch.Tensor,
                          action_onehot: torch.Tensor, *, sample: bool = False,
                          seed: int = 0) -> torch.Tensor:
    """Drop-in int8 serving transition with the operands of
    ``int8_kernel.py:211``."""
    packed = pack_int8_weights(params)
    out = int8_transition(packed, z.to(torch.int8), action_onehot,
                          head="sample" if sample else "sigmoid", seed=seed)
    return out.to(z.dtype)
