"""The int8 transition kernel's paths at every hidden width up to 128 and
any action count, on the CPU: test_torch_port_widths.py's cases (widths
between the kernels' multiples of 16, the multiples added last, centipede's
18 actions) for the int8 operands, which pad to the next multiple of 16
and compute the same function bit for bit, and for the port's three int8
entry points against the JAX package's, bit for bit (the Pallas kernels in
interpret mode)."""

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
    LATENT,
    _embed,
    _inputs,
    _transition_params,
    case,
)


def _padded_int8(packed):
    """The plain int8 version's operands at the kernels' width: every
    weight unpacked from the kernel's layout (conv1's latent rows)."""
    hp = tft.kernel_hidden(packed["hidden"])
    segments = [(ti.UNIT,), (hp,), (hp,), (hp,), (hp, hp), (hp, hp)]
    couts = [hp] * 5 + [packed["latent_pad"]]
    w = [_unpack(k, segs, cout) for k, segs, cout in zip(packed["kw"], segments, couts)]
    w[0] = w[0][:, :packed["latent_dim"]]
    return dict(packed, hidden=hp, w=w)


@pytest.mark.parametrize("order", ["joint", "sum_first", "bias_first"])
def test_padded_int8_operands_compute_the_same_function(case, order):
    """Bit for bit: exact int32 sums, and a padded channel requantizes to
    0.  The layouts unpack to the model's int8 weights, zero past its
    width."""
    tp, _, hidden, actions = case
    packed = {"joint": lambda: tq.quantize_transition(tp).packed,
              "sum_first": lambda: ti.pack_quantized_weights(tp),
              "bias_first": lambda: ti.pack_int8_weights(tp)}[order]()
    hp = tft.kernel_hidden(hidden)
    padded = _padded_int8(packed)
    segs = [(LATENT,), (hidden,), (hidden,), (hidden,), (hidden, hidden), (hidden, hidden)]
    for i, (w, seg) in enumerate(zip(packed["w"], segs)):
        want = _embed(w, seg, LATENT if i == 0 else hp, hp if i < 5 else w.shape[2])
        torch.testing.assert_close(padded["w"][i], want, rtol=0, atol=0)
    assert tuple(packed["w1a"].shape) == (actions, hp)
    assert not packed["w1a"][:, hidden:].any()
    z, a = _inputs(2, actions)
    zt, at = torch.from_numpy(z).to(torch.int8), torch.from_numpy(a)
    torch.testing.assert_close(ti.int8_transition_logits(padded, zt, at),
                               ti.int8_transition_logits(packed, zt, at), rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["transition_int8_v2", "quantized_transition",
                                   "int8_fused_transition"])
def test_int8_matches_jax(case, same_sn, pallas_interpret, entry):
    tp, jp, _, actions = case
    z, a = _inputs(5, actions)
    # each JAX function jitted whole: one compile a width, not one an op
    if entry == "transition_int8_v2":
        want = jax.jit(lambda p, z, a: jq.transition_int8_v2(jq.quantize_transition(p), z, a))(
            jp, jnp.asarray(z), jnp.asarray(a))
        got = tq.transition_int8_v2(tq.quantize_transition(tp), torch.from_numpy(z),
                                    torch.from_numpy(a))
    else:
        jfn = {"quantized_transition": jqk.quantized_transition,
               "int8_fused_transition": jik.int8_fused_transition}[entry]
        want = jax.jit(jfn)(jp, jnp.asarray(z), jnp.asarray(a))
        got = getattr(ti, entry)(tp, torch.from_numpy(z), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.02 < float(got.float().mean()) < 0.98


def test_wider_than_the_kernels_packs_and_runs_on_the_cpu_path(same_sn):
    """Past the kernels' 128 channels the packing keeps no kernel layout
    (the card's wrapper raises, naming the limit) and the CPU path still
    serves the width, as the JAX package does: bit-equal to JAX's
    ``transition_int8_v2`` at hidden 144."""
    params = _transition_params(144, 5, seed=144)
    tp = jax.tree.map(torch.from_numpy, params)
    qt = tq.quantize_transition(tp)
    assert qt.packed["kw"] is None and qt.packed["hidden"] == 144
    with pytest.raises(ValueError, match="hidden widths 1 to 128"):
        tft.kernel_hidden(qt.packed["hidden"])
    z, a = _inputs(6, 5)
    want = jax.jit(lambda p, z, a: jq.transition_int8_v2(jq.quantize_transition(p), z, a))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(z), jnp.asarray(a))
    got = tq.transition_int8_v2(qt, torch.from_numpy(z), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
