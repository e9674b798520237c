"""Every hidden width up to 128 and any action count on the transition
kernels' paths, on the CPU.

The kernels are instantiated at the multiples of 16 up to 128; a model of
another width runs at the next one on zero-padded operands.  Here, at widths
between those multiples (50, 104), at the multiples added last (16, 32, 96,
112) and with centipede's 18 actions: the padded operands compute the same
function as the model at its own width, they unpack to the model's weights,
and the port's CPU path matches the JAX package (bf16 against the Pallas
kernel in interpret mode, f32 against XLA).  test_torch_port_widths_int8.py
holds the int8 kernel's operands and paths at the same cases.  The
CUDA kernels themselves are held against their plain versions at these
shapes by the ``cuda``-marked tests of test_torch_port_kernels.py and
test_torch_port_int8_kernel.py, and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import scmgan_tpu.ops.pallas.fused_transition as jft
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.ops.conv import conv2d as jconv2d
from scmgan_tpu_torch.ops.kernels import fused_transition as tft

LATENT = 16
# (hidden, actions)
CASES = [(16, 5), (32, 5), (50, 5), (96, 5), (104, 5), (112, 5), (96, 18)]
IDS = [f"h{h}-a{a}" for h, a in CASES]
# f32 against XLA: the same convs summed in another order.
RTOL = ATOL = 1e-5
P_EDGE_F32 = 1e-6
# the padded operands against the model's width: the same products plus
# exact zeros, summed in another order.
PAD_ATOL = 1e-6
# bf16 against the Pallas kernel (test_torch_port_kernels.py): a latent bit
# may flip only where |p - 0.5| < 0.02.
P_EDGE_BF16 = 0.02


def _transition_params(hidden, actions, seed):
    """A random transition in the JAX package's tree (HWIO weights, biases,
    spectral-norm vectors warmed by power iteration), from numpy."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout, sn=True):
        bound = 1.0 / np.sqrt(9 * cin)
        p = {"w": rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
             "b": rng.uniform(-bound, bound, cout).astype(np.float32)}
        if sn:
            m = p["w"].reshape(-1, cout).T.astype(np.float64)
            v = rng.standard_normal(m.shape[1])
            for _ in range(10):
                u = m @ v
                u /= np.linalg.norm(u)
                v = m.T @ u
                v /= np.linalg.norm(v)
            p["sn"] = {"u": u.astype(np.float32), "v": v.astype(np.float32)}
        return p

    return {"conv1": conv(LATENT + actions, hidden), "conv2": conv(hidden, hidden),
            "conv3": conv(hidden, hidden), "conv4": conv(hidden, hidden),
            "conv5": conv(2 * hidden, hidden), "conv6": conv(2 * hidden, LATENT, sn=False)}


@pytest.fixture(params=CASES, ids=IDS)
def case(request):
    """(torch transition, JAX transition, hidden, actions): the same random
    numbers on both sides."""
    hidden, actions = request.param
    params = _transition_params(hidden, actions, seed=hidden + actions)
    return (jax.tree.map(torch.from_numpy, params), jax.tree.map(jnp.asarray, params),
            hidden, actions)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    interp = lambda *a, **k: orig(*a, **{**k, "interpret": True})  # noqa: E731
    monkeypatch.setattr(jft.pl, "pallas_call", interp)


def _inputs(seed, actions, b=2, hw=16):
    rng = np.random.default_rng(seed)
    z = (rng.random((b, hw, hw, LATENT)) > 0.5).astype(np.float32)
    a = np.eye(actions, dtype=np.float32)[rng.integers(0, actions, b)]
    return z, a


def _unpack_bf16(k, segments, cout):
    """Invert ``kernel_layout``: (chunks, 9, Cout, 64) -> (9, Cin, Cout),
    asserting that every slot past a segment's end is zero."""
    parts, chunk = [], 0
    for seg in segments:
        for start in range(0, seg, tft.CHUNK):
            width = min(tft.CHUNK, seg - start)
            assert not k[chunk, :, :, width:].any()
            parts.append(k[chunk, :, :, :width].transpose(1, 2))
            chunk += 1
    assert chunk == k.shape[0] and k.shape[2] == cout
    return torch.cat(parts, dim=1)


def _embed(w, segments, seg_pad, cout_pad):
    """``w`` (9, Cin, Cout), its K segments (``segments``: channel counts)
    each placed at the start of ``seg_pad`` rows, in zeros of (9,
    len(segments) * seg_pad, cout_pad)."""
    out = w.new_zeros((9, len(segments) * seg_pad, cout_pad))
    off = 0
    for j, seg in enumerate(segments):
        out[:, j * seg_pad:j * seg_pad + seg, :w.shape[2]] = w[:, off:off + seg]
        off += seg
    return out


def _padded_bf16(packed):
    """The plain version's operands at the kernels' width: conv2-6 unpacked
    from the kernel's layouts, conv1 zero-padded the same way, conv1-5's
    biases as the kernel reads them."""
    hp = tft.kernel_hidden(packed["hidden"])
    c1 = packed["c_in1_pad"]
    out = dict(packed, hidden=hp,
               w1=tft.pad_hidden(packed["w1"], (c1,), c1, hp))
    for i, segs in {2: (hp,), 3: (hp,), 4: (hp,), 5: (hp, hp), 6: (hp, hp)}.items():
        cout = packed["latent_pad"] if i == 6 else hp
        out[f"w{i}"] = _unpack_bf16(packed[f"k{i}"], segs, cout)
    return out


# -- the width a model runs at -----------------------------------------------

def test_kernel_hidden_rounds_up_and_refuses_past_the_limit():
    assert tft.HIDDENS == (16, 32, 48, 64, 80, 96, 112, 128)
    for h in range(1, tft.MAX_HIDDEN + 1):
        hp = tft.kernel_hidden(h)
        assert hp in tft.HIDDENS and h <= hp < h + 16
    for h in (0, tft.MAX_HIDDEN + 1, 256):
        with pytest.raises(ValueError, match="hidden widths 1 to 128"):
            tft.kernel_hidden(h)


# -- the padded operands ------------------------------------------------------

def test_padded_bf16_operands_compute_the_same_function(case):
    tp, _, hidden, actions = case
    packed = tft.pack_transition_weights(tp, LATENT, actions, dtype=torch.float32)
    assert packed["hidden"] == hidden
    z, a = (torch.from_numpy(x) for x in _inputs(1, actions))
    p = tft.transition_probs(packed, z, a)
    p_pad = tft.transition_probs(_padded_bf16(packed), z, a)
    np.testing.assert_allclose(p_pad.numpy(), p.numpy(), rtol=0, atol=PAD_ATOL)
    np.testing.assert_array_equal((p_pad > 0.5).numpy(), (p > 0.5).numpy())


def test_padded_bf16_layouts_hold_the_model(case):
    """k2..k6 unpack to the model's weights, zero past its width; w1_act is
    conv1's action rows summed over taps, zero past it; so are the biases;
    k1 holds conv1's latent rows."""
    tp, _, hidden, actions = case
    packed = tft.pack_transition_weights(tp, LATENT, actions)
    hp = tft.kernel_hidden(hidden)
    padded = _padded_bf16(packed)
    for i in range(2, 7):
        w = packed[f"w{i}"]
        segs = (hidden,) if i < 5 else (hidden, hidden)
        torch.testing.assert_close(padded[f"w{i}"], _embed(w, segs, hp, w.shape[2] if i == 6
                                                           else hp), rtol=0, atol=0)
    torch.testing.assert_close(_unpack_bf16(packed["k1"], (LATENT,), hp)[..., :hidden],
                               packed["w1"][:, :LATENT], rtol=0, atol=0)
    assert not packed["k1"][:, :, hidden:].any()
    w1_act = packed["w1"][:, LATENT:LATENT + actions].to(torch.float32).sum(0)
    assert tuple(packed["w1_act"].shape) == (actions, hp)
    torch.testing.assert_close(packed["w1_act"][:, :hidden], w1_act, rtol=0, atol=0)
    assert not packed["w1_act"][:, hidden:].any()
    for i in range(1, 6):
        assert tuple(packed[f"b{i}"].shape) == (hp,)
        torch.testing.assert_close(packed[f"b{i}"][:hidden], tp[f"conv{i}"]["b"],
                                   rtol=0, atol=0)
        assert not packed[f"b{i}"][hidden:].any()


# -- the port's CPU path against the JAX package -------------------------------

def test_transition_f32_matches_xla(case):
    tp, jp, _, actions = case
    z, a = _inputs(3, actions)
    packed = tft.pack_transition_weights(tp, LATENT, actions, dtype=torch.float32)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    p = tft.transition_probs(packed, zt, at)[..., :LATENT].numpy()
    bits = tft.fused_transition(packed, zt, at).numpy()
    # jitted whole: one compile a width, not one an op
    jall = jax.jit(lambda p, z, a: jwm.transition(p, z, a, train=False, return_all=True))(
        jp, jnp.asarray(z), jnp.asarray(a))
    jprob = np.asarray(jax.nn.sigmoid(jconv2d(
        jp["conv6"], jnp.concatenate([jall[4], jall[0]], -1), circular=True)))
    np.testing.assert_allclose(p, jprob, rtol=RTOL, atol=ATOL)
    flips = bits != np.asarray(jall[-1])
    assert np.all(np.abs(jprob[flips] - 0.5) < P_EDGE_F32)


def test_transition_bf16_matches_pallas(case, pallas_interpret):
    tp, jp, _, actions = case
    z, a = _inputs(4, actions)
    want = np.asarray(jax.jit(jft.fused_transition)(jp, jnp.asarray(z), jnp.asarray(a)))
    packed = tft.pack_transition_weights(tp, LATENT, actions)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    before = tft.fused_transition.launches
    got = tft.fused_transition(packed, zt, at).numpy()
    assert tft.fused_transition.launches == before   # the CPU path launches nothing
    p = tft.transition_probs(packed, zt, at, dtype=torch.bfloat16)[..., :LATENT]
    flips = got != want
    assert flips.mean() < 1e-3
    assert np.all(np.abs(p.numpy()[flips] - 0.5) < P_EDGE_BF16)
