"""The int8 transition kernel's paths at every latent and hidden width and
any action count, on the CPU: test_torch_port_widths.py's cases (widths
between the kernels' multiples of 16, the multiples, widths past one
128-channel tile whose K splits into 128-channel segments, latents 4, 8 and
32, centipede's 18 actions) for the int8 operands, which pad to the next
multiple of 16 and compute the same function bit for bit, and for the
port's three int8 entry points against the JAX package's, bit for bit (the
Pallas kernels in interpret mode), in every epilogue order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scmgan_tpu.ops.pallas.int8_kernel as jik
import scmgan_tpu.ops.pallas.quantized_transition as jqk
from scmgan_tpu.models import quantized as jq
from scmgan_tpu_torch.models import quantized as tq
from scmgan_tpu_torch.ops.kernels import fused_transition as tft
from scmgan_tpu_torch.ops.kernels import int8_transition as ti
from test_torch_port_int8_kernel import _unpack, pallas_interpret, same_sn  # noqa: F401
from test_torch_port_widths import (  # noqa: F401
    _embed,
    _inputs,
    _transition_params,
    case,
)


def _padded_int8(packed):
    """The plain int8 version's operands at the kernels' width: every
    weight unpacked from the kernel's layout (conv1's latent rows, zero past
    the latents)."""
    hp = tft.kernel_hidden(packed["hidden"])
    lp, latent = packed["latent_pad"], packed["latent_dim"]
    segments = [(lp,), (hp,), (hp,), (hp,), (hp, hp), (hp, hp)]
    couts = [hp] * 5 + [lp]
    w = [_unpack(k, segs, cout) for k, segs, cout in zip(packed["kw"], segments, couts)]
    assert not w[0][:, latent:].any()
    w[0] = w[0][:, :latent]
    return dict(packed, hidden=hp, w=w)


@pytest.mark.parametrize("order", ["joint", "sum_first", "bias_first"])
def test_padded_int8_operands_compute_the_same_function(case, order):
    """Bit for bit: exact int32 sums, and a padded channel requantizes to
    0.  The layouts unpack to the model's int8 weights, zero past its
    width."""
    tp, latent, hidden, actions = case.tp, case.latent, case.hidden, case.actions
    packed = {"joint": lambda: tq.quantize_transition(tp).packed,
              "sum_first": lambda: ti.pack_quantized_weights(tp),
              "bias_first": lambda: ti.pack_int8_weights(tp)}[order]()
    hp = tft.kernel_hidden(hidden)
    padded = _padded_int8(packed)
    segs = [(latent,), (hidden,), (hidden,), (hidden,), (hidden, hidden), (hidden, hidden)]
    for i, (w, seg) in enumerate(zip(packed["w"], segs)):
        want = _embed(w, seg, latent if i == 0 else hp, hp if i < 5 else w.shape[2])
        torch.testing.assert_close(padded["w"][i], want, rtol=0, atol=0)
    assert tuple(packed["w1a"].shape) == (actions, hp)
    assert not packed["w1a"][:, hidden:].any()
    z, a = case.inputs(2)
    zt, at = torch.from_numpy(z).to(torch.int8), torch.from_numpy(a)
    torch.testing.assert_close(ti.int8_transition_logits(padded, zt, at),
                               ti.int8_transition_logits(packed, zt, at), rtol=0, atol=0)


ENTRIES = ["transition_int8_v2", "quantized_transition", "int8_fused_transition"]
# each case's JAX references, all three entry points jitted together once
# (one compile a case, not one an entry), on the inputs of seed 5
_JAX_INT8 = {}


def _jax_int8(case):
    key = (case.latent, case.hidden, case.actions)
    if key not in _JAX_INT8:
        fn = jax.jit(lambda p, z, a: {
            "transition_int8_v2": jq.transition_int8_v2(jq.quantize_transition(p), z, a),
            "quantized_transition": jqk.quantized_transition(p, z, a),
            "int8_fused_transition": jik.int8_fused_transition(p, z, a)})
        z, a = case.inputs(5)
        _JAX_INT8[key] = jax.tree.map(np.asarray, fn(case.jp, jnp.asarray(z), jnp.asarray(a)))
    return _JAX_INT8[key]


@pytest.mark.parametrize("entry", ENTRIES)
def test_int8_matches_jax(case, same_sn, pallas_interpret, entry):
    """Bit for bit, each entry point in its own epilogue order (joint,
    sum_first, bias_first); past 128 channels the split orders sum each
    tensor's 128-channel K segments into one accumulator."""
    tp = case.tp
    z, a = case.inputs(5)
    want = _jax_int8(case)[entry]
    if entry == "transition_int8_v2":
        got = tq.transition_int8_v2(tq.quantize_transition(tp), torch.from_numpy(z),
                                    torch.from_numpy(a))
    else:
        got = getattr(ti, entry)(tp, torch.from_numpy(z), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.02 < float(got.float().mean()) < 0.98


def test_wider_than_128_packs_split_k_segments_that_unpack_to_the_model(same_sn):
    """Past 128 channels an input tensor is read as K segments of 128
    channels and the rest (``k_segments``), each on whole weight tiles; the
    layout at hidden 144 unpacks through that plan to the model's int8
    weights in every order, and runs on the CPU path bit-equal to JAX's
    ``transition_int8_v2``."""
    assert ti.k_segments((144,)) == [(0, 0, 128), (0, 128, 16)]
    assert ti.k_segments((208, 208)) == [(0, 0, 128), (0, 128, 80), (1, 0, 128), (1, 128, 80)]
    for c in range(16, 305, 16):
        segs = ti.k_segments((c, c))
        assert [s for s in segs if s[0] == 0] == [(0, off, min(128, c - off))
                                                   for off in range(0, c, 128)]
        plan = ti.k_plan((c, c))
        # every (tensor, tap, unit) once, a segment on whole tiles
        assert sorted(e for e in plan if e is not None) == sorted(
            (t, tap, j) for t in range(2) for tap in range(9) for j in range(c // 16))
        starts, k = [], 0
        for _, _, width in segs:
            starts.append(k)
            k += -(-9 * width // 16 // ti.TILE_UNITS) * ti.TILE_UNITS
        assert len(plan) == k and all(s % ti.TILE_UNITS == 0 for s in starts)
    params = _transition_params(144, 5, seed=144)
    tp = jax.tree.map(torch.from_numpy, params)
    qt = tq.quantize_transition(tp)
    for packed in (qt.packed, ti.pack_quantized_weights(tp), ti.pack_int8_weights(tp)):
        assert packed["hidden"] == 144 and len(packed["kw"]) == 6
        for i, (k, w) in enumerate(zip(packed["kw"][1:], packed["w"][1:]), start=1):
            segs = (144,) if i < 4 else (144, 144)
            torch.testing.assert_close(_unpack(k, segs, w.shape[2]), w, rtol=0, atol=0)
    z, a = _inputs(6, 5, hw=8)
    want = jax.jit(lambda p, z, a: jq.transition_int8_v2(jq.quantize_transition(p), z, a))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(z), jnp.asarray(a))
    got = tq.transition_int8_v2(qt, torch.from_numpy(z), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
