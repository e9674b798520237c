"""Every latent and hidden width and any action count on the transition
kernels' paths, on the CPU.

The kernels are instantiated at output tiles of every multiple of 16 up to
128; a layer of another width runs at the next multiple on zero-padded
operands, a wider one as several tiles, and conv1 reads the latents
zero-padded to a multiple of 16.  Here, at widths between those multiples
(50, 104, 200), at the multiples (16, 32, 96, 112), past one tile (144, 200,
256), at latents 4, 8 and 32 and with centipede's 18 actions: the padded
operands compute the same function as the model at its own width, they
unpack to the model's weights, and the port's CPU path matches the JAX
package (bf16 against the Pallas kernel in interpret mode, f32 against
XLA).  test_torch_port_widths_int8.py holds the int8 kernel's operands and
paths at the same cases.  The CUDA kernels themselves are held against
their plain versions at these shapes by the ``cuda``-marked tests of
test_torch_port_kernels.py and test_torch_port_int8_kernel.py, and by
``chip_smoke.py``.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import scmgan_tpu.ops.pallas.fused_transition as jft
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.ops.conv import conv2d as jconv2d
from scmgan_tpu_torch.ops.kernels import fused_decoder as tfd
from scmgan_tpu_torch.ops.kernels import fused_transition as tft
from scmgan_tpu_torch.ops.kernels import int8_transition as ti

LATENT = 16
# (latent, hidden, actions)
CASES = [(16, 16, 5), (16, 32, 5), (16, 50, 5), (16, 96, 5), (16, 104, 5), (16, 112, 5),
         (16, 96, 18), (16, 144, 5), (8, 200, 5), (16, 256, 4), (4, 64, 5), (8, 128, 5),
         (32, 128, 5)]
IDS = [f"h{h}-a{a}" if l == LATENT else f"l{l}-h{h}-a{a}" for l, h, a in CASES]
# the cases past the multiples of 16 up to 128 run on 8x8 images: their
# references cost more a pixel
SIDE = {c: 16 if c[0] == LATENT and c[1] <= 128 else 8 for c in CASES}
# f32 against XLA: the same convs summed in another order.
RTOL = ATOL = 1e-5
P_EDGE_F32 = 1e-6
# the padded operands against the model's width: the same products plus
# exact zeros, summed in another order.
PAD_ATOL = 1e-6
# bf16 against the Pallas kernel (test_torch_port_kernels.py): a latent bit
# may flip only where |p - 0.5| < 0.02.
P_EDGE_BF16 = 0.02


def _transition_params(hidden, actions, seed, latent=LATENT):
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

    return {"conv1": conv(latent + actions, hidden), "conv2": conv(hidden, hidden),
            "conv3": conv(hidden, hidden), "conv4": conv(hidden, hidden),
            "conv5": conv(2 * hidden, hidden), "conv6": conv(2 * hidden, latent, sn=False)}


class Case(NamedTuple):
    """One case: the same random numbers on both sides."""
    tp: dict        # torch transition
    jp: dict        # JAX transition
    latent: int
    hidden: int
    actions: int
    side: int       # image side of the case's inputs

    def inputs(self, seed):
        return _inputs(seed, self.actions, hw=self.side, latent=self.latent)


@pytest.fixture(params=CASES, ids=IDS)
def case(request):
    latent, hidden, actions = request.param
    seed = hidden + actions + (0 if latent == LATENT else 1000 * latent)
    params = _transition_params(hidden, actions, seed, latent)
    return Case(jax.tree.map(torch.from_numpy, params), jax.tree.map(jnp.asarray, params),
                latent, hidden, actions, SIDE[request.param])


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    interp = lambda *a, **k: orig(*a, **{**k, "interpret": True})  # noqa: E731
    monkeypatch.setattr(jft.pl, "pallas_call", interp)


def _inputs(seed, actions, b=2, hw=16, latent=LATENT):
    rng = np.random.default_rng(seed)
    z = (rng.random((b, hw, hw, latent)) > 0.5).astype(np.float32)
    a = np.eye(actions, dtype=np.float32)[rng.integers(0, actions, b)]
    return z, a


def _unpack_bf16(k, segments, cout):
    """Invert ``kernel_layout``: (chunks, 9, Cout, 64) -> (9, Cin, Cout),
    asserting that every slot past a segment's end is zero.  An N tile's
    launch reads rows n0 .. n0 + width - 1 of each (chunk, tap)."""
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
    latent, lp = packed["latent_dim"], packed["latent_pad"]
    # conv1's latent rows from k1 (zero past the latents), its action rows
    w1 = tft.pad_hidden(packed["w1"], (c1,), c1, hp)
    k1 = _unpack_bf16(packed["k1"], (lp,), hp)
    assert not k1[:, latent:].any()
    w1[:, :latent] = k1[:, :latent]
    out = dict(packed, hidden=hp, w1=w1)
    for i, segs in {2: (hp,), 3: (hp,), 4: (hp,), 5: (hp, hp), 6: (hp, hp)}.items():
        cout = packed["latent_pad"] if i == 6 else hp
        out[f"w{i}"] = _unpack_bf16(packed[f"k{i}"], segs, cout)
    return out


# -- the width a model runs at -----------------------------------------------

def test_kernel_hidden_rounds_up_and_n_tiles_cover_the_width():
    """Any width runs at the next multiple of 16, in output-channel tiles of
    the instantiated widths: each channel in exactly one tile, all tiles
    128 wide but the last (the head's 16 wide)."""
    assert tft.N_TILES == (16, 32, 48, 64, 80, 96, 112, 128)
    for h in range(1, 301):
        hp = tft.kernel_hidden(h)
        assert hp % 16 == 0 and h <= hp < h + 16
        for head in (False, True):
            tiles = tft.n_tiles(hp, head=head)
            step = 16 if head else tft.MAX_N_TILE
            assert [n0 for n0, _ in tiles] == list(range(0, hp, step))
            assert all(width in tft.N_TILES for _, width in tiles)
            assert all(width == step for _, width in tiles[:-1])
            assert sum(width for _, width in tiles) == hp
    assert tft.n_tiles(144) == [(0, 128), (128, 16)]
    assert tft.n_tiles(208) == [(0, 128), (128, 80)]
    assert tft.n_tiles(256) == [(0, 128), (128, 128)]
    assert tft.n_tiles(32, head=True) == [(0, 16), (16, 16)]
    with pytest.raises(ValueError, match="at least one hidden channel"):
        tft.kernel_hidden(0)
    for c in (0, 24):
        with pytest.raises(ValueError, match="multiple of 16"):
            tft.n_tiles(c)


@pytest.mark.parametrize("latent", [1, 4, 8, 17, 32, 64])
def test_operands_pack_at_every_width(latent):
    """``pack_transition_weights``, the int8 ``pack_operands`` and
    ``pack_decoder_weights`` build the kernels' operands at every latent
    and hidden width: widths padded to multiples of 16, conv1's layout over
    the padded latents, every int8 layout tiling its K plan."""
    rng = np.random.default_rng(latent)
    for hidden in (1, 17, 128, 129, 144, 200, 256, 300):
        hp, lp = tft.kernel_hidden(hidden), tft.round_up(latent, 16)
        params = jax.tree.map(torch.from_numpy, _transition_params(hidden, 3, latent, latent))
        pt = tft.pack_transition_weights(params, latent, 3)
        assert (pt["latent_pad"], pt["hidden"]) == (lp, hidden)
        assert tuple(pt["k1"].shape) == (-(-lp // 64), 9, hp, 64)
        assert tuple(pt["k5"].shape) == (2 * -(-hp // 64), 9, hp, 64)
        assert tuple(pt["k6"].shape) == (2 * -(-hp // 64), 9, lp, 64)
        assert tuple(pt["w1_act"].shape) == (3, hp)
        packed = ti.pack_int8_weights(params)
        segs = [(lp,), (hp,), (hp,), (hp,), (hp, hp), (hp, hp)]
        for k, seg, cout in zip(packed["kw"], segs, [hp] * 5 + [lp]):
            assert tuple(k.shape) == (len(ti.k_plan(seg)) // ti.TILE_UNITS, cout, 128)
    dec = {"conv1": {"w": torch.from_numpy(rng.standard_normal((3, 3, latent, 4 * latent))
                                           .astype(np.float32)),
                     "b": torch.zeros(4 * latent)},
           "conv2": {"w": torch.from_numpy(rng.standard_normal((3, 3, 4 * latent, 3 * latent))
                                           .astype(np.float32)),
                     "b": torch.zeros(3 * latent)}}
    pd = tfd.pack_decoder_weights(dec, latent)
    hp = tft.round_up(4 * latent, 16)
    assert (pd["latent_pad"], pd["hidden_pad"], pd["color"]) == (lp, hp, 3)
    assert tuple(pd["k1"].shape) == (9, lp, hp) and tuple(pd["k2"].shape) == (9, hp, 3)
    torch.testing.assert_close(pd["k1"][:, :latent, :4 * latent], pd["w1"], rtol=0, atol=0)
    assert not pd["k1"][:, latent:].any() and not pd["k1"][:, :, 4 * latent:].any()


# -- the padded operands ------------------------------------------------------

def test_padded_bf16_operands_compute_the_same_function(case):
    packed = tft.pack_transition_weights(case.tp, case.latent, case.actions,
                                         dtype=torch.float32)
    assert packed["hidden"] == case.hidden
    z, a = (torch.from_numpy(x) for x in case.inputs(1))
    p = tft.transition_probs(packed, z, a)
    p_pad = tft.transition_probs(_padded_bf16(packed), z, a)
    np.testing.assert_allclose(p_pad.numpy(), p.numpy(), rtol=0, atol=PAD_ATOL)
    np.testing.assert_array_equal((p_pad > 0.5).numpy(), (p > 0.5).numpy())


def test_padded_bf16_layouts_hold_the_model(case):
    """k2..k6 unpack to the model's weights, zero past its width; w1_act is
    conv1's action rows summed over taps, zero past it; so are the biases;
    k1 holds conv1's latent rows, zero past them."""
    tp, latent, hidden, actions = case.tp, case.latent, case.hidden, case.actions
    packed = tft.pack_transition_weights(tp, latent, actions)
    hp = tft.kernel_hidden(hidden)
    padded = _padded_bf16(packed)
    for i in range(2, 7):
        w = packed[f"w{i}"]
        segs = (hidden,) if i < 5 else (hidden, hidden)
        torch.testing.assert_close(padded[f"w{i}"], _embed(w, segs, hp, w.shape[2] if i == 6
                                                           else hp), rtol=0, atol=0)
    k1 = _unpack_bf16(packed["k1"], (packed["latent_pad"],), hp)
    torch.testing.assert_close(k1[:, :latent, :hidden], packed["w1"][:, :latent],
                               rtol=0, atol=0)
    assert not k1[:, latent:].any() and not k1[:, :, hidden:].any()
    w1_act = packed["w1"][:, latent:latent + actions].to(torch.float32).sum(0)
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
    tp, jp, latent, actions = case.tp, case.jp, case.latent, case.actions
    z, a = case.inputs(3)
    packed = tft.pack_transition_weights(tp, latent, actions, dtype=torch.float32)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    p = tft.transition_probs(packed, zt, at)[..., :latent].numpy()
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
    tp, jp, latent, actions = case.tp, case.jp, case.latent, case.actions
    z, a = case.inputs(4)
    want = np.asarray(jax.jit(jft.fused_transition)(jp, jnp.asarray(z), jnp.asarray(a)))
    packed = tft.pack_transition_weights(tp, latent, actions)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    before = tft.fused_transition.launches
    got = tft.fused_transition(packed, zt, at).numpy()
    assert tft.fused_transition.launches == before   # the CPU path launches nothing
    p = tft.transition_probs(packed, zt, at, dtype=torch.bfloat16)[..., :latent]
    flips = got != want
    assert flips.mean() < 1e-3
    assert np.all(np.abs(p.numpy()[flips] - 0.5) < P_EDGE_BF16)
