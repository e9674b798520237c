"""The port's two kernels (scmgan_tpu_torch.ops.kernels) on the CPU: their
plain versions against the JAX XLA functions in f32 and against the Pallas
kernels in interpret mode in bf16, their weight packing, and the wrappers'
device rules.  The CUDA kernels themselves run only on a card: the tests
marked ``cuda`` hold them against their plain versions there and skip here."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import scmgan_tpu.ops.pallas.fused_decoder as jfd
import scmgan_tpu.ops.pallas.fused_transition as jft
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.ops.conv import conv2d as jconv2d
from scmgan_tpu_torch.models.world_model import init_decoder, init_transition
from scmgan_tpu_torch.ops.conv import conv2d as tconv2d
from scmgan_tpu_torch.ops.kernels import _build as tkb
from scmgan_tpu_torch.ops.kernels import fused_decoder as tfd
from scmgan_tpu_torch.ops.kernels import fused_transition as tft
from scmgan_tpu_torch.train.checkpoint import load_model, load_pytree

MODELS = os.path.join(os.path.dirname(__file__), "..", "pretrained_models")
BUNDLE = os.path.join(MODELS, "minipacman_cf")
# Bundles whose shapes differ: minipacman (5 actions, 3 colours), pong (4
# actions: conv1 takes 20 channels) and boxes (4 actions, 1 colour).
BUNDLES = ("minipacman_cf", "pong_cf", "boxes_cf")
# Transitions of every hidden width the kernel takes: the teacher (128) and
# the students (48, 64, 80; 80 splits into a 64- and a 16-channel chunk).
TRANSITIONS = ("minipacman_cf", "minipacman_student_h48",
               "minipacman_student_h64", "minipacman_student_h80", "pong_cf")
# Random transitions at widths and action counts no shipped model has: the
# kernels' other multiples of 16, widths between them (run on zero-padded
# weights) and centipede's 18 actions; "h<hidden>-a<actions>".
RANDOM_TRANSITIONS = ("h16-a5", "h32-a5", "h50-a5", "h96-a5", "h104-a5", "h112-a5",
                      "h128-a18")
LATENT, ACTIONS = 16, 5
# f32 mode against XLA: the same convs summed in another order.
RTOL = ATOL = 1e-5
P_EDGE_F32 = 1e-6
# bf16 mode against the Pallas kernel: both multiply bf16 exactly and sum in
# f32 in another order, so an activation's bf16 rounding can differ by one
# ulp; a latent bit may flip only where |p - 0.5| < 0.02, and bf16 logits may
# differ by a few ulps (0.02 + 0.02 |x|).
P_EDGE_BF16 = 0.02
BF16_TOL = 0.02


@pytest.fixture(scope="module")
def model():
    return load_model(BUNDLE, device="cpu")


@pytest.fixture(scope="module")
def jax_model(model):
    return jwm.WorldModel(**{
        name: jax.tree.map(lambda t: t.numpy(), getattr(model, name))
        for name in jwm.WorldModel._fields})


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    interp = lambda *a, **k: orig(*a, **{**k, "interpret": True})  # noqa: E731
    monkeypatch.setattr(jft.pl, "pallas_call", interp)
    monkeypatch.setattr(jfd.pl, "pallas_call", interp)


_BUNDLE_CACHE = {}


def _bundle(name):
    """(torch model, JAX model, number of actions) of a shipped bundle."""
    if name not in _BUNDLE_CACHE:
        m = load_model(os.path.join(MODELS, name), device="cpu")
        jm = jwm.WorldModel(**{
            f: jax.tree.map(lambda t: t.numpy(), getattr(m, f))
            for f in jwm.WorldModel._fields})
        _BUNDLE_CACHE[name] = (m, jm, m.transition["conv1"]["w"].shape[2] - LATENT)
    return _BUNDLE_CACHE[name]


def _transition_params(name, device="cpu"):
    """The transition of a bundle or a student (or a random one of
    RANDOM_TRANSITIONS), and its number of actions."""
    if name in RANDOM_TRANSITIONS:
        hidden, actions = (int(x[1:]) for x in name.split("-"))
        gen = torch.Generator(device=device).manual_seed(hidden + actions)
        return init_transition(gen, LATENT, actions, hidden=hidden), actions
    path = os.path.join(MODELS, name, "model-transition.npz")
    params = load_pytree(path, device)
    return params, params["conv1"]["w"].shape[2] - LATENT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, b=2, hw=16, actions=ACTIONS):
    rng = np.random.default_rng(seed)
    z = (rng.random((b, hw, hw, LATENT)) > 0.5).astype(np.float32)
    a = np.eye(actions, dtype=np.float32)[rng.integers(0, actions, b)]
    return z, a


# -- packing -------------------------------------------------------------

@pytest.mark.parametrize("bundle", BUNDLES)
def test_pack_transition_weights_matches_jax(bundle):
    model, jax_model, actions = _bundle(bundle)
    ours = tft.pack_transition_weights(model.transition, LATENT, actions)
    ref = jft.pack_transition_weights(jax_model.transition, LATENT, actions)
    shapes = {k: tuple(ours[k].shape) for k in ("w1", "w2", "w5", "w6", "b1", "b6")}
    assert shapes == {"w1": (9, 32, 128), "w2": (9, 128, 128),
                      "w5": (9, 256, 128), "w6": (9, 256, 16),
                      "b1": (128,), "b6": (16,)}
    assert all(ours[f"w{i}"].dtype == torch.bfloat16 for i in range(1, 7))
    assert (ours["c_in1_pad"], ours["latent_pad"]) == (32, 16)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    ulp = dict(rtol=2 ** -7, atol=1e-6)  # sigma summed in another order
    c_ref = ref["w1"].shape[1]   # JAX pads conv1's input to a multiple of 8
    np.testing.assert_allclose(f32(ours["w1"].float())[:, :c_ref], f32(ref["w1"]), **ulp)
    assert not ours["w1"][:, LATENT + actions:].any()
    for i in (2, 3, 4):
        np.testing.assert_allclose(f32(ours[f"w{i}"].float()), f32(ref[f"w{i}"]), **ulp)
    for i in (5, 6):
        w = f32(ours[f"w{i}"].float())
        np.testing.assert_allclose(w[:, :128], f32(ref[f"w{i}a"]), **ulp)
        np.testing.assert_allclose(w[:, 128:], f32(ref[f"w{i}b"]), **ulp)
    for i in range(1, 7):
        np.testing.assert_allclose(ours[f"b{i}"].numpy(), f32(ref[f"b{i}"])[0],
                                   rtol=1e-6)


@pytest.mark.parametrize("bundle", BUNDLES)
def test_pack_decoder_weights_matches_jax(bundle):
    model, jax_model, _ = _bundle(bundle)
    ours = tfd.pack_decoder_weights(model.decoder, LATENT)
    ref = jfd.pack_decoder_weights(jax_model.decoder, LATENT)
    color = ref["color"]
    assert color == (1 if bundle == "boxes_cf" else 3)
    assert tuple(ours["w1"].shape) == (9, 16, 64)
    assert tuple(ours["w2"].shape) == (9, 64, color)
    assert ours["color"] == color
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    np.testing.assert_array_equal(f32(ours["w1"].float()), f32(ref["w1"]))
    np.testing.assert_allclose(f32(ours["w2"].float()), f32(ref["w2"])[..., :color],
                               rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(ours["b2"].numpy(), f32(ref["b2"])[0, :color],
                               rtol=1e-6)


@pytest.mark.parametrize("name", TRANSITIONS)
def test_kernel_layout_holds_every_weight(name):
    """k1..k6 hold each (9, Cin, Cout) weight in 64-channel chunks per K
    segment, K-major, zero past a segment's end; conv1 the latent channels."""
    params, actions = _transition_params(name)
    packed = tft.pack_transition_weights(params, LATENT, actions)
    hidden = packed["w2"].shape[-1]
    segments = {1: (LATENT,), 2: (hidden,), 3: (hidden,), 4: (hidden,),
                5: (hidden, hidden), 6: (hidden, hidden)}
    for i, segs in segments.items():
        w, k = packed[f"w{i}"], packed[f"k{i}"]
        cout = w.shape[-1]
        assert k.dtype == torch.bfloat16 and k.is_contiguous()
        assert tuple(k.shape) == (sum(-(-c // 64) for c in segs), 9, cout, 64)
        chunk, off = 0, 0
        for seg in segs:
            for start in range(0, seg, 64):
                width = min(64, seg - start)
                torch.testing.assert_close(
                    k[chunk, :, :, :width],
                    w[:, off + start:off + start + width, :].transpose(1, 2),
                    rtol=0, atol=0)
                assert not k[chunk, :, :, width:].any()
                chunk += 1
            off += seg
        assert chunk == k.shape[0]


@pytest.mark.parametrize("name", TRANSITIONS)
def test_action_bias_equals_the_one_hot_half_of_conv1(name):
    """The kernel's conv1 reads only the latents and adds act @ w1_act: under
    circular padding that equals the conv of [z | one-hot action]."""
    params, actions = _transition_params(name)
    packed = tft.pack_transition_weights(params, LATENT, actions,
                                         dtype=torch.float32)
    w1 = packed["w1"]
    np.testing.assert_allclose(
        packed["w1_act"].numpy(),
        w1[:, LATENT:LATENT + actions].sum(dim=0).numpy(), rtol=1e-6, atol=1e-7)
    z, a = (torch.from_numpy(x) for x in _inputs(8, actions=actions))
    b, h, w, _ = z.shape
    x = torch.cat([z, a[:, None, None, :].expand(b, h, w, actions),
                   z.new_zeros((b, h, w, w1.shape[1] - LATENT - actions))], -1)
    full = tconv2d({"w": w1.reshape(3, 3, *w1.shape[1:]), "b": packed["b1"]}, x,
                   circular=True)
    w1z = w1[:, :LATENT]
    split = tconv2d({"w": w1z.reshape(3, 3, *w1z.shape[1:]), "b": packed["b1"]}, z,
                    circular=True) + (a @ packed["w1_act"])[:, None, None, :]
    np.testing.assert_allclose(split.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile_m", [tft.TILE_M, 128])
@pytest.mark.parametrize("hw", [(64, 64), (12, 12), (5, 33), (64, 1), (7, 65),
                                (100, 130)])
def test_tile_plan_covers_each_image_once(hw, tile_m):
    """Every pixel of an image lies in exactly one tile; a tile stays inside
    one image, holds at most tile_m pixels (the transition kernels' 256, the
    int8 kernel's 128 for split orders at N >= 80), and its input rows fit
    the kernel's chunk buffer."""
    h, w = hw
    plan = tft.tile_plan(h, w, tile_m)
    rows, tw, tws = plan["rows"], plan["tw"], plan["tws"]
    assert rows * tw <= tile_m
    assert (rows + 2) * tws <= tft.A_SLOTS
    assert tws == (w if w <= 64 else 66) and tw == min(w, 64)
    seen = np.zeros((h, w), np.int32)
    for rb in range(plan["row_blocks"]):
        for cb in range(plan["col_blocks"]):
            y0, x0 = rb * rows, cb * 64
            assert y0 < h and x0 < w          # no empty tile
            seen[y0:y0 + rows, x0:x0 + tw] += 1
    assert (seen == 1).all()


def test_ptxas_report_reads_registers_shared_memory_and_spills(tmp_path, monkeypatch):
    """The build keeps ptxas -v's output beside the library; ptxas_report
    turns it into one row per kernel."""
    lib = tmp_path / "libscmgan_kernels_0.so"
    monkeypatch.setattr(tkb, "library_path", lambda: lib)
    (tmp_path / "libscmgan_kernels_0.so.ptxas.txt").write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN6scm_tr13conv3x3_wgmmaILi128ELi0EEEvNS_8ConvArgsE14CUtensorMap_st' for 'sm_90a'\n"
        "ptxas info    : Function properties for x\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 900 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_113decode_kernelEPKfPK13__nv_bfloat16S1_S4_S1_PS2_iiii' for 'sm_90a'\n"
        "ptxas info    : Used 80 registers, 16 bytes smem, 400 bytes cmem[0]\n")
    assert tkb.ptxas_report() == [
        {"kernel": "conv3x3_wgmma<128,0>", "registers": 168, "smem_static": 0,
         "spill_bytes": 12},
        {"kernel": "decode_kernel", "registers": 80, "smem_static": 16,
         "spill_bytes": 0}]


# -- transition ----------------------------------------------------------

def test_transition_plain_f32_matches_xla(model, jax_model):
    z, a = _inputs(0)
    packed = tft.pack_transition_weights(model.transition, LATENT, ACTIONS,
                                         dtype=torch.float32)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    p = tft.transition_probs(packed, zt, at)[..., :LATENT].numpy()
    bits = tft.transition_plain(packed, zt, at).numpy()
    jall = jwm.transition(jax_model.transition, jnp.asarray(z), jnp.asarray(a),
                          train=False, return_all=True)
    jp = np.asarray(jax.nn.sigmoid(jconv2d(
        jax_model.transition["conv6"],
        jnp.concatenate([jall[4], jall[0]], -1), circular=True)))
    np.testing.assert_allclose(p, jp, rtol=RTOL, atol=ATOL)
    flips = bits != np.asarray(jall[-1])
    assert np.all(np.abs(jp[flips] - 0.5) < P_EDGE_F32)


@pytest.mark.parametrize("bundle", BUNDLES)
def test_transition_plain_bf16_matches_pallas(bundle, pallas_interpret):
    model, jax_model, actions = _bundle(bundle)
    z, a = _inputs(1, actions=actions)
    want = np.asarray(jft.fused_transition(jax_model.transition, jnp.asarray(z),
                                           jnp.asarray(a)))
    packed = tft.pack_transition_weights(model.transition, LATENT, actions)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    got = tft.transition_plain(packed, zt, at, dtype=torch.bfloat16).numpy()
    p = tft.transition_probs(packed, zt, at, dtype=torch.bfloat16)[..., :LATENT]
    flips = got != want
    assert flips.mean() < 1e-3
    assert np.all(np.abs(p.numpy()[flips] - 0.5) < P_EDGE_BF16)


def test_philox_matches_known_answers():
    # Random123's known-answer vectors for philox4x32-10
    words = lambda *v: [np.array([x], np.uint64) for x in v]  # noqa: E731
    cases = [
        (words(0, 0, 0, 0), (0, 0),
         (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (words(*[0xFFFFFFFF] * 4), (0xFFFFFFFF, 0xFFFFFFFF),
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (words(0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for counter, key, want in cases:
        got = tuple(int(w[0]) for w in tft.philox4x32(counter, key))
        assert got == want


def test_philox_uniform_stream():
    u = tft.philox_uniform(7, (4, 8, 8, 16))
    assert u.shape == (4, 8, 8, 16) and u.dtype == np.float32
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.02
    np.testing.assert_array_equal(u, tft.philox_uniform(7, (4, 8, 8, 16)))
    assert (u != tft.philox_uniform(8, (4, 8, 8, 16))).mean() > 0.99


def test_transition_wrapper_takes_plain_version_on_cpu(model):
    z, a = _inputs(2)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    packed = tft.pack_transition_weights(model.transition, LATENT, ACTIONS)
    before = tft.fused_transition.launches
    np.testing.assert_array_equal(
        tft.fused_transition(packed, zt, at).numpy(),
        tft.transition_plain(packed, zt, at, dtype=torch.bfloat16).numpy())
    sampled = tft.fused_transition(packed, zt, at, sample=True, seed=11)
    u = torch.from_numpy(tft.philox_uniform(11, (2, 16, 16, 16)))
    np.testing.assert_array_equal(
        sampled.numpy(),
        tft.transition_plain(packed, zt, at, u=u, dtype=torch.bfloat16).numpy())
    assert tft.fused_transition.launches == before  # the CPU path launches nothing


# -- decoder -------------------------------------------------------------

def test_decode_plain_f32_matches_xla(model, jax_model):
    z, _ = _inputs(3)
    packed = tfd.pack_decoder_weights(model.decoder, LATENT, dtype=torch.float32)
    got = tfd.decode_plain(packed, torch.from_numpy(z)).numpy()
    want = np.asarray(jwm.decode_fused(jax_model.decoder, jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bundle", BUNDLES)
@pytest.mark.parametrize("corner", [False, True], ids=["random", "corner"])
def test_decode_plain_bf16_matches_pallas(bundle, pallas_interpret, corner):
    model, jax_model, _ = _bundle(bundle)
    z, _ = _inputs(4)
    if corner:  # SAME zero padding: a lone corner pixel must not wrap around
        z = np.zeros_like(z)
        z[0, 0, 0, :] = 1.0
    want = np.asarray(jfd.fused_decode(jax_model.decoder, jnp.asarray(z)),
                      np.float32)
    packed = tfd.pack_decoder_weights(model.decoder, LATENT)
    got = tfd.decode_plain(packed, torch.from_numpy(z), dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_decode_wrapper_takes_plain_version_on_cpu(model):
    z, _ = _inputs(5)
    packed = tfd.pack_decoder_weights(model.decoder, LATENT)
    before = tfd.fused_decode.launches
    got = tfd.fused_decode(packed, torch.from_numpy(z))
    want = tfd.decode_plain(packed, torch.from_numpy(z), dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    assert tfd.fused_decode.launches == before


def test_wrappers_refuse_other_devices(model):
    packed_t = tft.pack_transition_weights(model.transition, LATENT, ACTIONS)
    packed_d = tfd.pack_decoder_weights(model.decoder, LATENT)
    z = torch.empty((1, 8, 8, LATENT), device="meta")
    a = torch.empty((1, ACTIONS), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tft.fused_transition(packed_t, z, a)
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.fused_decode(packed_d, z)


# -- on the card ---------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("hw", [64, 12])
@pytest.mark.parametrize("name", TRANSITIONS + RANDOM_TRANSITIONS)
def test_transition_kernel_matches_plain_on_card(card, name, hw):
    params, actions = _transition_params(name, card)
    packed = tft.pack_transition_weights(params, LATENT, actions)
    z, a = (torch.from_numpy(x).to(card)
            for x in _inputs(6, b=4, hw=hw, actions=actions))
    got = tft.fused_transition(packed, z, a)
    want = tft.transition_plain(packed, z, a, dtype=torch.bfloat16)
    p = tft.transition_probs(packed, z, a, dtype=torch.bfloat16)[..., :LATENT]
    flips = got != want
    assert float(flips.float().mean()) < 1e-3
    assert bool(((p[flips] - 0.5).abs() < P_EDGE_BF16).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [64, 12])
@pytest.mark.parametrize("bundle", BUNDLES)
def test_decoder_kernel_matches_plain_on_card(card, bundle, hw):
    m = load_model(os.path.join(MODELS, bundle), device=card)
    packed = tfd.pack_decoder_weights(m.decoder, LATENT)
    z, _ = _inputs(7, b=4, hw=hw)
    z = torch.from_numpy(z).to(card)
    got = tfd.fused_decode(packed, z).float()
    want = tfd.decode_plain(packed, z, dtype=torch.bfloat16).float()
    assert bool(((got - want).abs() <= BF16_TOL + BF16_TOL * want.abs()).all())


# (latent, hidden, actions) past one 128-channel tile and at other latents
SHAPES = [(16, 144, 5), (8, 200, 5), (16, 256, 4), (4, 64, 5), (8, 128, 5), (32, 128, 5),
          (64, 256, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [64, 12])
@pytest.mark.parametrize("latent,hidden,actions", SHAPES,
                         ids=[f"l{l}-h{h}-a{a}" for l, h, a in SHAPES])
def test_transition_kernel_matches_plain_at_every_shape(card, latent, hidden, actions, hw):
    """Output-channel tiles past 128 and conv1 / the head at other latent
    widths: both heads against the plain version (the sample head's
    uniforms from the host's Philox draw)."""
    gen = torch.Generator(device=card).manual_seed(latent * 1000 + hidden)
    params = init_transition(gen, latent, actions, hidden=hidden)
    packed = tft.pack_transition_weights(params, latent, actions)
    rng = np.random.default_rng(hidden)
    z = torch.from_numpy((rng.random((4, hw, hw, latent)) > 0.5).astype(np.float32)).to(card)
    a = torch.from_numpy(np.eye(actions, dtype=np.float32)[rng.integers(0, actions, 4)]).to(card)
    p = tft.transition_probs(packed, z, a, dtype=torch.bfloat16)[..., :latent]
    got = tft.fused_transition(packed, z, a)
    flips = got != tft.transition_plain(packed, z, a, dtype=torch.bfloat16)
    assert float(flips.float().mean()) < 1e-3
    assert bool(((p[flips] - 0.5).abs() < P_EDGE_BF16).all())
    u = torch.from_numpy(tft.philox_uniform(3, (4, hw, hw, packed["latent_pad"]))).to(card)
    sampled = tft.fused_transition(packed, z, a, sample=True, seed=3)
    diff = sampled != tft.transition_plain(packed, z, a, u=u, dtype=torch.bfloat16)
    assert bool(((u[..., :latent][diff] - p[diff]).abs() < P_EDGE_BF16).all())


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [64, 12])
@pytest.mark.parametrize("color", [1, 3])
@pytest.mark.parametrize("latent", [4, 8, 32, 64, 80])
def test_decoder_kernel_matches_plain_at_every_latent(card, latent, color, hw):
    """Any latent L and intermediate width 4L, zero-padded to multiples of
    16; past 64 latents the input is read in groups of 64 channels."""
    gen = torch.Generator(device=card).manual_seed(latent + color)
    packed = tfd.pack_decoder_weights(init_decoder(gen, latent, color), latent)
    rng = np.random.default_rng(latent)
    z = torch.from_numpy((rng.random((4, hw, hw, latent)) > 0.5).astype(np.float32)).to(card)
    got = tfd.fused_decode(packed, z).float()
    want = tfd.decode_plain(packed, z, dtype=torch.bfloat16).float()
    assert bool(((got - want).abs() <= BF16_TOL + BF16_TOL * want.abs()).all())
