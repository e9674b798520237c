"""The port's int8 transition kernel (ops/kernels/int8_transition.py) on the
CPU: its plain version in each of its three epilogue orders against the two
Pallas int8 kernels (in interpret mode, at the small size the JAX package's
own tests use: latent 8, 16x16, hidden 128) and against the XLA int8 path,
bit for bit; the kernel's weight layout; and the wrapper's device rules.
The CUDA kernel runs only on a card: the tests marked ``cuda`` hold it
against its plain version there and skip here.

Both sides get the same spectral-norm-folded weights (see
test_torch_port_quantized.py for why).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import scmgan_tpu.ops.pallas.int8_kernel as jik
import scmgan_tpu.ops.pallas.quantized_transition as jqk
from scmgan_tpu.models import init_world_model
from scmgan_tpu.models import quantized as jq
from scmgan_tpu.ops.spectral_norm import sn_weight as jax_sn_weight
from scmgan_tpu_torch.models import quantized as tq
from scmgan_tpu_torch.models.world_model import init_transition
from scmgan_tpu_torch.ops.kernels import fused_transition as tft
from scmgan_tpu_torch.ops.kernels import int8_transition as ti
from scmgan_tpu_torch.train.checkpoint import load_pytree

REPO = os.path.join(os.path.dirname(__file__), "..")
LATENT, ACTIONS = 8, 4


def _jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def small():
    """A random transition at the JAX tests' size, as numpy-backed tensors."""
    wm = init_world_model(jax.random.PRNGKey(0), LATENT, ACTIONS, 1, 3, 3,
                          img_size=16)
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), wm.transition)


@pytest.fixture
def same_sn(monkeypatch):
    def sn(p):
        return torch.from_numpy(np.array(jax_sn_weight(_jax(p))))
    monkeypatch.setattr(ti, "sn_weight", sn)
    monkeypatch.setattr(tq, "sn_weight", sn)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    interp = lambda *a, **k: orig(*a, **{**k, "interpret": True})  # noqa: E731
    monkeypatch.setattr(jqk.pl, "pallas_call", interp)
    monkeypatch.setattr(jik.pl, "pallas_call", interp)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, b=2, hw=16, latent=LATENT, actions=ACTIONS):
    rng = np.random.default_rng(seed)
    z = (rng.random((b, hw, hw, latent)) > 0.5).astype(np.float32)
    a = np.eye(actions, dtype=np.float32)[rng.integers(0, actions, b)]
    return z, a


# -- the plain version against the JAX package ---------------------------

@pytest.mark.parametrize("entry", ["quantized_transition", "int8_fused_transition"])
def test_plain_matches_pallas(small, same_sn, pallas_interpret, entry):
    """Split halves, static scales, each kernel's own summation order."""
    jfn = {"quantized_transition": jqk.quantized_transition,
           "int8_fused_transition": jik.int8_fused_transition}[entry]
    tfn = getattr(ti, entry)
    z, a = _inputs(0)
    want = np.asarray(jfn(_jax(small), jnp.asarray(z), jnp.asarray(a)))
    got = tfn(small, torch.from_numpy(z), torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, LATENT)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_plain_joint_matches_xla_int8(small, same_sn, version):
    z, a = _inputs(1)
    jfn, tfn = {"v1": (jq.transition_int8, tq.transition_int8),
                "v2": (jq.transition_int8_v2, tq.transition_int8_v2)}[version]
    want = np.asarray(jfn(jq.quantize_transition(_jax(small)), jnp.asarray(z),
                          jnp.asarray(a)))
    got = tfn(tq.quantize_transition(small), torch.from_numpy(z),
              torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_orders_differ_only_in_rounding(small, same_sn):
    """The two Pallas orders round the same three f32 terms differently:
    their logits agree to a few ulps, not bit for bit."""
    z, a = _inputs(2)
    zt, at = torch.from_numpy(z).to(torch.int8), torch.from_numpy(a)
    la = ti.int8_transition_logits(ti.pack_quantized_weights(small),
                                   zt, at)
    lb = ti.int8_transition_logits(ti.pack_int8_weights(small),
                                   zt, at)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=1e-5, atol=1e-5)


# -- packing -------------------------------------------------------------

def _unpack(kw, segments, cout):
    """Invert pack_kernel_weights through k_plan: (tiles, Cout, 128) ->
    (9, Cin, Cout), asserting that every padding slot is zero."""
    slots = kw.reshape(-1, cout, ti.TILE_UNITS, ti.UNIT).transpose(1, 2) \
        .reshape(-1, cout, ti.UNIT)
    plan = ti.k_plan(segments)
    assert slots.shape[0] == len(plan)
    offsets = [sum(segments[:i]) for i in range(len(segments))]
    w9 = kw.new_zeros((9, sum(segments), cout))
    for slot, entry in zip(slots, plan):
        if entry is None:
            assert not slot.any()
        else:
            seg, tap, j = entry
            c = offsets[seg] + j * ti.UNIT
            w9[tap, c:c + ti.UNIT] = slot.T
    return w9


@pytest.mark.parametrize("bundle,hidden", [("minipacman_cf", 128),
                                           ("minipacman_student_h48", 48)])
def test_packing_shapes_and_layout(bundle, hidden):
    """Each packing's kernel weights: (tiles, Cout, 128) int8, one tile per
    8 K slots of the K plan, and exactly the int8 weights they came from."""
    params = load_pytree(os.path.join(REPO, "pretrained_models", bundle,
                                      "model-transition.npz"), "cpu")
    tiles = lambda c: -(-9 * c // (ti.UNIT * ti.TILE_UNITS))  # noqa: E731
    for packed, order in [(tq.quantize_transition(params).packed, "joint"),
                          (ti.pack_quantized_weights(params), "sum_first"),
                          (ti.pack_int8_weights(params), "bias_first")]:
        assert packed["order"] == order
        assert (packed["hidden"], packed["latent_dim"], packed["num_actions"],
                packed["latent_pad"]) == (hidden, 16, 5, 16)
        kw = packed["kw"]
        assert [tuple(k.shape) for k in kw] == [
            (tiles(16), hidden, 128), (tiles(hidden), hidden, 128),
            (tiles(hidden), hidden, 128), (tiles(hidden), hidden, 128),
            (2 * tiles(hidden), hidden, 128), (2 * tiles(hidden), 16, 128)]
        assert all(k.dtype == torch.int8 and k.is_contiguous() for k in kw)
        torch.testing.assert_close(_unpack(kw[0], (16,), hidden), packed["w"][0],
                                   rtol=0, atol=0)
        for i in range(1, 6):
            w = packed["w"][i]
            segments = (hidden,) if i < 4 else (hidden, hidden)
            torch.testing.assert_close(_unpack(kw[i], segments, w.shape[2]), w,
                                       rtol=0, atol=0)
        assert tuple(packed["w1a"].shape) == (5, hidden)
        assert packed["w1a"].dtype == torch.int32
        split = order != "joint"
        for i in (4, 5):
            assert isinstance(packed["s"][i], tuple) == split
        assert all(tuple(r.shape) == (hidden,) for r in packed["rq"])
        assert tuple(packed["b"][5].shape) == (16,)


@pytest.mark.parametrize("segments,steps", [
    ((16,), [5]), ((48,), [14]), ((64,), [18]), ((80,), [23]), ((128,), [36]),
    ((128, 128), [36, 36])], ids=["16", "48", "64", "80", "128", "2x128"])
def test_k_plan(segments, steps):
    """Every (segment, tap, unit) once, in tap order; ceil(9u / 2) k32 steps
    a segment of u units, the rest of its last tile zero padding; no k32
    step mixes two segments (the split orders keep their sums apart)."""
    plan = ti.k_plan(segments)
    assert len(plan) % ti.TILE_UNITS == 0
    want = [(s, tap, j) for s, c in enumerate(segments)
            for tap in range(9) for j in range(c // ti.UNIT)]
    assert [e for e in plan if e is not None] == want
    pairs = [plan[k:k + ti.STEP_UNITS] for k in range(0, len(plan), ti.STEP_UNITS)]
    used = [p for p in pairs if any(e is not None for e in p)]
    for p in used:
        assert len({e[0] for e in p if e is not None}) == 1
    assert [sum(1 for p in used if p[0][0] == s) for s in range(len(segments))] == steps
    # a segment starts on a new tile: its first slot is at a tile boundary
    for s in range(len(segments)):
        first = next(k for k, e in enumerate(plan) if e is not None and e[0] == s)
        assert first % ti.TILE_UNITS == 0
    w9 = torch.randint(-127, 128, (9, sum(segments), 16), dtype=torch.int8)
    kw = ti.pack_kernel_weights(w9, segments)
    assert tuple(kw.shape) == (len(plan) // ti.TILE_UNITS, 16, 128)
    torch.testing.assert_close(_unpack(kw, segments, 16), w9, rtol=0, atol=0)


def test_k_plan_refuses_other_widths():
    for c in (0, 8, 24, 136):
        with pytest.raises(ValueError, match="segment"):
            ti.k_plan((c,))


def test_action_bias_equals_the_action_half_of_conv1(small):
    """conv1 over [z | one-hot] equals conv1 over z plus the rank-1 bias."""
    z, a = _inputs(3)
    packed = tq.quantize_transition(small).packed
    w1 = tq.quantize_transition(small).weights["conv1"]
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    x = torch.cat([zt, at[:, None, None, :].expand(2, 16, 16, ACTIONS)], -1)
    full = ti._int_conv(x.to(torch.int8), w1.reshape(9, *w1.shape[2:]))
    split = ti._int_conv(zt.to(torch.int8), packed["w"][0]) \
        + ti._action_bias(packed, at)[:, None, None, :]
    torch.testing.assert_close(full, split, rtol=0, atol=0)


# -- the wrapper ----------------------------------------------------------

def test_wrapper_takes_plain_version_on_cpu(small):
    z, a = _inputs(4)
    packed = tq.quantize_transition(small).packed
    zt, at = torch.from_numpy(z).to(torch.int8), torch.from_numpy(a)
    before = ti.int8_transition.launches
    for head in ("logit", "sigmoid"):
        torch.testing.assert_close(
            ti.int8_transition(packed, zt, at, head=head),
            ti.int8_transition_plain(packed, zt, at, head=head), rtol=0, atol=0)
    u = torch.from_numpy(tft.philox_uniform(9, (2, 16, 16, packed["latent_pad"])))
    sampled = ti.int8_transition(packed, zt, at, head="sample", seed=9)
    torch.testing.assert_close(
        sampled, ti.int8_transition_plain(packed, zt, at, head="sample", u=u),
        rtol=0, atol=0)
    assert 0.05 < sampled.float().mean() < 0.95
    assert ti.int8_transition.launches == before  # the CPU path launches nothing


def test_wrapper_refuses_other_devices_and_heads(small):
    packed = tq.quantize_transition(small).packed
    z = torch.empty((1, 8, 8, LATENT), dtype=torch.int8, device="meta")
    a = torch.empty((1, ACTIONS), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ti.int8_transition(packed, z, a)
    with pytest.raises(ValueError, match="head"):
        ti.int8_transition(packed, z, a, head="requant")
    with pytest.raises(ValueError, match="order"):
        ti.pack_operands({}, {}, {}, {}, order="fma")


# -- on the card ---------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("packing", ["joint", "sum_first", "bias_first"])
@pytest.mark.parametrize("b,hw", [(4, 64), (3, 12)], ids=["full", "ragged"])
@pytest.mark.parametrize("hidden,actions", [
    (48, 5), (16, 5), (32, 5), (50, 5), (96, 5), (104, 5), (112, 5), (128, 18)],
    ids=["h48-student", "h16", "h32", "h50", "h96", "h104", "h112", "h128-a18"])
def test_int8_kernel_matches_plain_on_card(card, packing, b, hw, hidden, actions):
    """Bit for bit; at 12 x 12 a 256-pixel tile holds 144 pixels (21 rows
    of 12, 12 of them in the image) and a 128-pixel split tile 120.  The
    shipped h48 student, and random transitions at the kernel's other
    multiples of 16, at widths between them (zero-padded operands) and with
    centipede's 18 actions."""
    if (hidden, actions) == (48, 5):
        params = load_pytree(os.path.join(REPO, "pretrained_models",
                                          "minipacman_student_h48",
                                          "model-transition.npz"), card)
    else:
        gen = torch.Generator(device=card).manual_seed(hidden + actions)
        params = init_transition(gen, 16, actions, hidden=hidden)
    packed = {"joint": lambda: tq.quantize_transition(params).packed,
              "sum_first": lambda: ti.pack_quantized_weights(params),
              "bias_first": lambda: ti.pack_int8_weights(params)}[packing]()
    z, a = _inputs(5, b=b, hw=hw, latent=16, actions=actions)
    zt = torch.from_numpy(z).to(card, torch.int8)
    at = torch.from_numpy(a).to(card)
    for head in ("logit", "sigmoid"):
        got = ti.int8_transition(packed, zt, at, head=head)
        want = ti.int8_transition_plain(packed, zt, at, head=head)
        assert int((got != want).sum()) == 0


SHAPES = [(16, 144, 5), (8, 200, 5), (16, 256, 4), (4, 64, 5), (8, 128, 5), (32, 128, 5),
          (64, 256, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("packing", ["joint", "sum_first", "bias_first"])
@pytest.mark.parametrize("b,hw", [(4, 64), (3, 12)], ids=["full", "ragged"])
@pytest.mark.parametrize("latent,hidden,actions", SHAPES,
                         ids=[f"l{l}-h{h}-a{a}" for l, h, a in SHAPES])
def test_int8_kernel_matches_plain_at_every_shape(card, packing, b, hw, latent, hidden,
                                                  actions):
    """Bit for bit past 128 channels (N tiles, K split into 128-channel
    segments, the split orders' sums per tensor) and at other latents."""
    gen = torch.Generator(device=card).manual_seed(latent * 1000 + hidden)
    params = init_transition(gen, latent, actions, hidden=hidden)
    packed = {"joint": lambda: tq.quantize_transition(params).packed,
              "sum_first": lambda: ti.pack_quantized_weights(params),
              "bias_first": lambda: ti.pack_int8_weights(params)}[packing]()
    z, a = _inputs(5, b=b, hw=hw, latent=latent, actions=actions)
    zt = torch.from_numpy(z).to(card, torch.int8)
    at = torch.from_numpy(a).to(card)
    for head in ("logit", "sigmoid"):
        got = ti.int8_transition(packed, zt, at, head=head)
        want = ti.int8_transition_plain(packed, zt, at, head=head)
        assert int((got != want).sum()) == 0
