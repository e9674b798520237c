"""The transition step as a hand-written CUDA kernel, and its plain version.

Port of ``scmgan_tpu/ops/pallas/fused_transition.py`` (``fused_transition``,
``pack_transition_weights``).  The kernel is ``csrc/fused_transition.cu``
with ``csrc/transition_conv.cuh``: six launches of an implicit-GEMM circular
3x3 conv on ``wgmma`` with a fused epilogue.
``transition_plain`` is the same function in PyTorch, with the same
arithmetic: bf16 weights, f32 accumulation, activations rounded to bf16
between layers when ``dtype`` is bf16, or all in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from scmgan_tpu_torch.ops.conv import conv2d, leaky_relu
from scmgan_tpu_torch.ops.kernels import _build
from scmgan_tpu_torch.ops.spectral_norm import sn_weight

# conv1's input (latent + actions) is padded to 32 channels in the plain
# version's weights, conv6's output to whole 16-wide MMA tiles.  Both
# transition kernels are instantiated at every multiple of 16 up to
# MAX_N_TILE (N_TILES): a layer of another width runs at the next multiple of
# 16 on zero-padded weights (``kernel_hidden``), and one wider than
# MAX_N_TILE as several output-channel tiles (``n_tiles``), since the
# accumulators of a 128-channel tile already fill a thread's registers.  The
# head's tiles are 16 wide.
K_STEP = 32
N_TILE_HEAD = 16
MAX_N_TILE = 128
N_TILES = tuple(range(N_TILE_HEAD, MAX_N_TILE + 1, N_TILE_HEAD))
# The kernel's K chunk (input channels copied to shared memory at a time, one
# 128-byte swizzled row a pixel), its tile (output pixels a block) and the
# input pixels a chunk buffer holds.
CHUNK = 64
TILE_M = 256
A_SLOTS = 6 * 66


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def kernel_hidden(hidden: int) -> int:
    """The width the transition kernels run a ``hidden``-channel model at:
    the next multiple of 16."""
    if hidden < 1:
        raise ValueError(f"a transition has at least one hidden channel; got {hidden}")
    return round_up(hidden, N_TILE_HEAD)


def n_tiles(cout: int, head: bool = False) -> list:
    """The output-channel tiles a kernel layer of ``cout`` channels (a
    multiple of 16) runs as, ``(first channel, width)`` each, one launch a
    tile: hidden layers in tiles of MAX_N_TILE and the rest (144 = 128 + 16,
    208 = 128 + 80), the head in tiles of 16.  Mirrors ``conv`` in
    ``csrc/fused_transition.cu`` and ``csrc/int8_transition.cu``."""
    if cout < 1 or cout % N_TILE_HEAD:
        raise ValueError(f"a kernel layer has a positive multiple of 16 channels; got {cout}")
    step = N_TILE_HEAD if head else MAX_N_TILE
    return [(n0, min(step, cout - n0)) for n0 in range(0, cout, step)]


def pad_hidden(w9: torch.Tensor, segments, hp: int, cout_pad: int) -> torch.Tensor:
    """A (9, Cin, Cout) stack with each K segment (``segments``: the input
    tensors' channel counts, concatenated along Cin) zero-padded to ``hp``
    channels and Cout to ``cout_pad``: the weights of the same conv on inputs
    whose extra channels are zero."""
    parts, off = [], 0
    for seg in segments:
        parts.append(torch.nn.functional.pad(w9[:, off:off + seg], (0, 0, 0, hp - seg)))
        off += seg
    w = torch.cat(parts, dim=1)
    return torch.nn.functional.pad(w, (0, cout_pad - w.shape[-1])).contiguous()


def kernel_layout(w9: torch.Tensor, segments) -> torch.Tensor:
    """The kernel's weight layout: a (9, Cin, Cout) stack whose K rows fall
    in ``segments`` (the channel counts of the input tensors, concatenated
    along Cin) becomes (chunks, 9, Cout, CHUNK): chunk c holds up to CHUNK
    channels of one segment for every tap, K-major (the wgmma B operand),
    zero past the segment's end.  Rows of the result are the TMA boxes the
    kernel streams in order."""
    taps, _, cout = w9.shape
    blocks, off = [], 0
    for seg in segments:
        for start in range(0, seg, CHUNK):
            width = min(CHUNK, seg - start)
            blk = w9.new_zeros((taps, cout, CHUNK))
            blk[:, :, :width] = w9[:, off + start:off + start + width, :].transpose(1, 2)
            blocks.append(blk)
        off += seg
    return torch.stack(blocks).contiguous()


def tile_plan(height: int, width: int, tile_m: int = TILE_M) -> dict:
    """How a transition kernel cuts one image into tiles of at most
    ``tile_m`` output pixels (256, or 128 for the int8 kernel's split-order
    tiles), none straddling two images: whole rows (``rows`` of them) when
    the width is at most 64, else rows of 64 columns.  ``tws`` is the input
    pixels a shared-memory row holds (the row itself, or 64 columns with a
    one-pixel halo each side)."""
    if width <= 64:
        tw, tws, col_blocks = width, width, 1
        rows = tile_m // width
    else:
        tw, tws, rows = 64, 66, tile_m // 64
        col_blocks = -(-width // 64)
    return {"tw": tw, "tws": tws, "rows": rows,
            "row_blocks": -(-height // rows), "col_blocks": col_blocks}


def pack_transition_weights(params: dict, latent_dim: int, num_actions: int,
                            dtype=torch.bfloat16) -> dict:
    """Host-side weight preparation, once per model.

    Each conv's HWIO weight becomes a (9, Cin, Cout) matrix stack with
    spectral normalization folded in (conv1-5); conv1's input channels are
    zero-padded to ``c_in1_pad``; conv5/conv6 keep their concatenated input
    axis (main half first, skip half second); conv6's output is zero-padded
    to ``latent_pad``.  Biases stay f32.  Beside them, the kernel's own
    operands: ``k1``..``k6`` in ``kernel_layout`` (conv1 over the latent
    channels only, zero-padded to ``latent_pad`` as the wrapper pads the
    latents, conv5/conv6 as two K segments read from two tensors), and
    ``w1_act``, conv1's one-hot action weights summed over taps in f32
    (actions, hidden): the conv of a spatially constant map under circular
    padding is that sum, so the kernel adds it as a per-sample bias.

    The kernel's operands (``k1``..``k6``, ``b1``..``b5``, ``w1_act``) are at
    the hidden width rounded up to 16, ``hp``: the extra output channels of
    conv1-5 have zero weights and bias, so they hold leaky-ReLU(0) = 0, and
    the next conv's weights for them are zero, so the step is the same
    function.  ``w1``..``w6`` and ``hidden`` stay at the model's width, and
    ``transition_probs`` computes there.
    """
    c_in1 = latent_dim + num_actions
    c_in1_pad = round_up(c_in1, K_STEP)
    latent_pad = round_up(latent_dim, N_TILE_HEAD)

    def mat(w):
        kh, kw, ci, co = w.shape
        return w.reshape(kh * kw, ci, co).to(dtype).contiguous()

    def bias(name, pad=0):
        b = params[name]["b"].to(torch.float32)
        return torch.nn.functional.pad(b, (0, pad)).contiguous()

    w1 = torch.nn.functional.pad(sn_weight(params["conv1"]),
                                 (0, 0, 0, c_in1_pad - c_in1))
    w6 = torch.nn.functional.pad(params["conv6"]["w"],
                                 (0, latent_pad - latent_dim))
    ws = {
        "w1": mat(w1),
        "w2": mat(sn_weight(params["conv2"])),
        "w3": mat(sn_weight(params["conv3"])),
        "w4": mat(sn_weight(params["conv4"])),
        "w5": mat(sn_weight(params["conv5"])),
        "w6": mat(w6),
    }
    hidden = ws["w2"].shape[-1]
    hp = kernel_hidden(hidden)
    segments = {1: (c_in1_pad,), 2: (hidden,), 3: (hidden,), 4: (hidden,),
                5: (hidden, hidden), 6: (hidden, hidden)}
    kin = {1: (latent_pad,), 2: (hp,), 3: (hp,), 4: (hp,), 5: (hp, hp), 6: (hp, hp)}
    wp = {i: pad_hidden(ws[f"w{i}"], segments[i], c_in1_pad if i == 1 else hp,
                        latent_pad if i == 6 else hp) for i in segments}
    w1_act = wp[1][:, latent_dim:c_in1, :].to(torch.float32).sum(dim=0).contiguous()
    # conv1 reads the latent rows, zero-padded to latent_pad
    wp[1] = pad_hidden(wp[1][:, :latent_dim], (latent_dim,), latent_pad, hp)
    return {
        **ws,
        **{f"k{i}": kernel_layout(wp[i], kin[i]) for i in kin},
        "w1_act": w1_act,
        **{f"b{i}": bias(f"conv{i}", hp - hidden) for i in range(1, 6)},
        "b6": bias("conv6", latent_pad - latent_dim),
        "latent_dim": latent_dim, "num_actions": num_actions, "hidden": hidden,
        "c_in1_pad": c_in1_pad, "latent_pad": latent_pad,
    }


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11) on numpy uint64 arrays holding
    32-bit words: counter (c0, c1, c2, c3), key (k0, k1) -> 4 output words."""
    mask = np.uint64(0xFFFFFFFF)
    c0, c1, c2, c3 = (np.asarray(c, np.uint64) for c in counter)
    k0, k1 = (np.uint64(k) for k in key)
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    for _ in range(10):
        p0, p1 = m0 * c0, m1 * c2
        hi0, lo0 = p0 >> np.uint64(32), p0 & mask
        hi1, lo1 = p1 >> np.uint64(32), p1 & mask
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + np.uint64(0x9E3779B9)) & mask
        k1 = (k1 + np.uint64(0xBB67AE85)) & mask
    return c0, c1, c2, c3


def philox_uniform(seed: int, shape) -> np.ndarray:
    """The kernel's sample-head uniforms: Philox4x32-10 keyed by ``seed``,
    counter = (flat index of the element in ``shape``, 0, 0), first output
    word, top 24 bits scaled to [0, 1).  Bit-identical to ``philox_u32`` in
    ``csrc/fused_transition.cu``."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    zero = np.zeros_like(idx)
    word = philox4x32(
        (idx & np.uint64(0xFFFFFFFF), idx >> np.uint64(32), zero, zero),
        (seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF))[0]
    u = (word >> np.uint64(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
    return u.reshape(shape)


def transition_probs(packed: dict, z: torch.Tensor,
                     action_onehot: torch.Tensor, *,
                     dtype=torch.float32) -> torch.Tensor:
    """The kernel's arithmetic up to the sigmoid, in PyTorch: p of shape
    (B, H, W, latent_pad) in f32.  ``dtype`` bf16 rounds the input and every
    activation to bf16 as the kernel stores them; f32 keeps all in f32."""
    if dtype == torch.bfloat16:
        rnd = lambda t: t.to(torch.bfloat16).to(torch.float32)  # noqa: E731
    elif dtype == torch.float32:
        rnd = lambda t: t  # noqa: E731
    else:
        raise ValueError(f"dtype must be float32 or bfloat16, not {dtype}")
    b, h, w, latent = z.shape
    num_actions = action_onehot.shape[-1]
    cpad = packed["c_in1_pad"] - latent - num_actions
    x = torch.cat([
        rnd(z.to(torch.float32)),
        action_onehot[:, None, None, :].to(torch.float32).expand(
            b, h, w, num_actions),
        z.new_zeros((b, h, w, cpad), dtype=torch.float32),
    ], dim=-1)

    def conv(i, inp):
        w9 = packed[f"w{i}"]
        w = w9.to(torch.float32).reshape(3, 3, *w9.shape[1:])
        # conv1-5's biases are the kernel's, padded past the model's width
        return conv2d({"w": w, "b": packed[f"b{i}"][:w.shape[-1]]}, inp, circular=True)

    h1 = rnd(leaky_relu(conv(1, x)))
    h2 = rnd(leaky_relu(conv(2, h1)))
    h3 = rnd(leaky_relu(conv(3, h2)))
    h4 = rnd(leaky_relu(conv(4, h3)))
    h5 = rnd(leaky_relu(conv(5, torch.cat([h4, h2], dim=-1))))
    return torch.sigmoid(conv(6, torch.cat([h5, h1], dim=-1)))


def transition_plain(packed: dict, z: torch.Tensor,
                     action_onehot: torch.Tensor, *, u=None,
                     dtype=torch.float32) -> torch.Tensor:
    """The kernel's function in PyTorch.  ``u`` None: threshold head
    (p > 0.5); else the sample head (u < p) with ``u`` of shape
    (B, H, W, latent_pad).  Returns latents in z's dtype."""
    p = transition_probs(packed, z, action_onehot, dtype=dtype)
    bits = p > 0.5 if u is None else u < p
    return bits[..., :z.shape[-1]].to(z.dtype)


def fused_transition(packed: dict, z: torch.Tensor,
                     action_onehot: torch.Tensor, *, sample: bool = False,
                     seed: int = 0) -> torch.Tensor:
    """Drop-in inference replacement for ``models.world_model.transition``.

    z: (B, H, W, latent); action_onehot: (B, A); any latent and hidden width
    and any number of actions.  Returns (B, H, W, latent) binary latents in
    z's dtype: thresholded at 0.5, or with ``sample`` drawn as Bernoulli(p)
    from the Philox stream keyed by ``seed``.
    A CUDA tensor launches the kernel (``packed`` in bf16 on the card); a
    CPU tensor takes ``transition_plain`` in the packed weights' dtype.
    """
    b, h, w, latent = z.shape
    latent_pad = packed["latent_pad"]
    shape_u = (b, h, w, latent_pad)
    if z.device.type == "cpu":
        u = torch.from_numpy(philox_uniform(seed, shape_u)) if sample else None
        return transition_plain(packed, z, action_onehot, u=u,
                                dtype=packed["w1"].dtype)
    if z.device.type != "cuda":
        raise ValueError(f"unsupported device {z.device}")
    num_actions = action_onehot.shape[-1]
    if (latent != packed["latent_dim"] or num_actions != packed["num_actions"]
            or action_onehot.shape[0] != b):
        raise ValueError("z / action shapes do not match the packed weights")
    hidden = kernel_hidden(packed["hidden"])
    weights = [packed[f"k{i}"] for i in range(1, 7)]
    biases = [packed[f"b{i}"] for i in range(1, 7)]
    for t in weights + biases + [packed["w1_act"]]:
        if t.device != z.device or not t.is_contiguous():
            raise ValueError("packed weights must be contiguous on z's device")
    if any(t.dtype != torch.bfloat16 for t in weights):
        raise ValueError("the kernel takes weights packed in bfloat16")
    zb = z.to(torch.bfloat16).contiguous()
    if latent != latent_pad:    # conv1 reads latent_pad channels: then zeros
        zb = torch.nn.functional.pad(zb, (0, latent_pad - latent))
    act = action_onehot.to(device=z.device, dtype=torch.float32).contiguous()
    scratch = torch.empty((4, b, h, w, hidden), dtype=torch.bfloat16,
                          device=z.device)
    out = torch.empty(shape_u, dtype=torch.bfloat16, device=z.device)
    plan = tile_plan(h, w)
    lib = _build.library()
    rc = lib.scm_transition_step(
        zb.data_ptr(), act.data_ptr(),
        *(t.data_ptr() for t in weights), *(t.data_ptr() for t in biases),
        packed["w1_act"].data_ptr(),
        *(s.data_ptr() for s in scratch), out.data_ptr(),
        b, h, w, num_actions, hidden, latent_pad,
        plan["tw"], plan["tws"], plan["rows"], plan["row_blocks"],
        plan["col_blocks"], int(sample), seed,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(rc, "fused_transition")
    fused_transition.launches += 1
    return out[..., :latent].to(z.dtype)


# Calls that launched the kernel (one call = one transition step = six conv
# launches); the CPU path does not count.
fused_transition.launches = 0
