"""The serving decoder as a hand-written CUDA kernel, and its plain version.

Port of ``scmgan_tpu/ops/pallas/fused_decoder.py`` (``fused_decode`` /
``fused_decode_packed``, ``pack_decoder_weights``).  The kernel is
``csrc/fused_decoder.cu``: one persistent launch computes both zero-padded
SAME 3x3 convs on bf16 tensor cores with the leaky-ReLU between, keeping the
intermediate in shared memory.  ``decode_plain`` is the same function in PyTorch with the same
arithmetic (bf16 intermediate and bf16 logits when ``dtype`` is bf16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scmgan_tpu_torch.ops.conv import conv2d, leaky_relu
from scmgan_tpu_torch.ops.kernels import _build
from scmgan_tpu_torch.ops.kernels.fused_transition import round_up

# The kernel takes any latent width L and intermediate width (4L from
# ``init_decoder``), each zero-padded to a multiple of SLICE, and at most
# MAX_COLOR colours (no env has more).
SLICE = 16
MAX_COLOR = 4


def pack_decoder_weights(params: dict, latent_dim: int,
                         dtype=torch.bfloat16) -> dict:
    """Host-side weight preparation, once per model: flip both
    transposed-conv kernels (a stride-1 pad-1 ConvTranspose is a SAME conv
    with the HW-flipped kernel) and fold the per-factor sum into conv2
    (exact by linearity, ``decode_fused``).  Weights become (9, Cin, Cout)
    stacks in ``dtype``; biases stay f32.  Beside them, the kernel's own
    operands ``k1`` (9, latent_pad, hidden_pad), ``kb1`` (hidden_pad) and
    ``k2`` (9, hidden_pad, color): both widths zero-padded to multiples of
    16, the same tensors as ``w1``, ``b1`` and ``w2`` where no padding is
    needed.  A padded intermediate channel has zero weights and bias, so it
    holds leaky-ReLU(0) = 0, and conv2's weights for it are zero."""
    w1 = params["conv1"]["w"].flip(0, 1)                 # (3, 3, L, 4L)
    w2 = params["conv2"]["w"].flip(0, 1)                 # (3, 3, 4L, L*color)
    kh, kw, hidden, lc = w2.shape
    color = lc // latent_dim
    w2s = w2.reshape(kh, kw, hidden, latent_dim, color).sum(dim=3)
    b2s = params["conv2"]["b"].reshape(latent_dim, color).sum(dim=0)

    def mat(w):
        a, b, ci, co = w.shape
        return w.reshape(a * b, ci, co).to(dtype).contiguous()

    def pad(x, *widths):
        """x zero-padded at the end of its last len(widths) axes to widths."""
        amounts = [n - size for n, size in zip(widths, x.shape[-len(widths):])]
        if not any(amounts):
            return x
        return F.pad(x, [v for n in reversed(amounts) for v in (0, n)]).contiguous()

    packed = {
        "w1": mat(w1), "w2": mat(w2s),
        "b1": params["conv1"]["b"].to(torch.float32).contiguous(),
        "b2": b2s.to(torch.float32).contiguous(),
        "latent_dim": latent_dim, "color": color,
        "latent_pad": round_up(latent_dim, SLICE), "hidden_pad": round_up(hidden, SLICE),
    }
    lp, hp = packed["latent_pad"], packed["hidden_pad"]
    packed.update(k1=pad(packed["w1"], lp, hp), kb1=pad(packed["b1"], hp),
                  k2=pad(packed["w2"], hp, color))
    return packed


def decode_plain(packed: dict, z: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in PyTorch: z (B, H, W, latent) -> pixel logits
    (B, H, W, color) in ``dtype``."""
    if dtype == torch.bfloat16:
        rnd = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    elif dtype == torch.float32:
        rnd = lambda t: t  # noqa: E731
    else:
        raise ValueError(f"dtype must be float32 or bfloat16, not {dtype}")

    def conv(i, inp):
        w9 = packed[f"w{i}"]
        w = w9.to(torch.float32).reshape(3, 3, *w9.shape[1:])
        return conv2d({"w": w, "b": packed[f"b{i}"]}, inp)

    h1 = rnd(leaky_relu(conv(1, rnd(z.to(torch.float32)))))
    return conv(2, h1).to(dtype)


def fused_decode(packed: dict, z: torch.Tensor) -> torch.Tensor:
    """Drop-in inference replacement for ``models.world_model.decode_fused``.

    z: (B, H, W, latent) latents of any float dtype, any latent width;
    returns logits (B, H, W, color).  A CUDA tensor launches the kernel
    (bf16 logits); a CPU tensor takes ``decode_plain`` in the packed
    weights' dtype.
    """
    if z.device.type == "cpu":
        return decode_plain(packed, z, dtype=packed["w1"].dtype)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    b, h, w, latent = z.shape
    color = packed["color"]
    if latent != packed["latent_dim"]:
        raise ValueError(f"z has {latent} latent channels, the weights {packed['latent_dim']}")
    if not 1 <= color <= MAX_COLOR:
        raise ValueError(f"the kernel takes 1 to {MAX_COLOR} colours; got {color}")
    tensors = [packed["k1"], packed["kb1"], packed["k2"], packed["b2"]]
    for t in tensors:
        if t.device != z.device or not t.is_contiguous():
            raise ValueError("packed weights must be contiguous on z's device")
    if packed["k1"].dtype != torch.bfloat16 or packed["k2"].dtype != torch.bfloat16:
        raise ValueError("the kernel takes weights packed in bfloat16")
    # The kernel reads f32 latents (as the free-run carries them), latent_pad
    # channels a pixel, and rounds them to bf16 on load.
    zk = z.to(torch.float32).contiguous()
    if latent != packed["latent_pad"]:
        zk = F.pad(zk, (0, packed["latent_pad"] - latent))
    out = torch.empty((b, h, w, color), dtype=torch.bfloat16, device=z.device)
    lib = _build.library()
    rc = lib.scm_decode(
        zk.data_ptr(), *(t.data_ptr() for t in tensors), out.data_ptr(),
        b, h, w, packed["latent_pad"], packed["hidden_pad"], color,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "fused_decode")
    fused_decode.launches += 1
    return out


# Calls that launched the kernel; the CPU path does not count.
fused_decode.launches = 0
