"""The rest of the port's models/quantized.py against scmgan_tpu's on the
CPU: the halo, split and ring variants of the int8 step, the bf16 epilogue
option, both threshold heads, the sample head on JAX's uniforms, and the
int8 decoder.

Both sides take the same quantized weights (the port's
``quantize_transition`` and ``calibrate_transition`` arrays, which
tests/test_torch_port_quantized.py holds bit-equal to JAX's, handed to
JAX's ``QuantizedTransition``), so the int32 sums are equal by construction
and every difference is the epilogue's or the head's.  Inputs are
gridworld-sized (16 x 16, latent 16, 5 actions, hidden 16; one packing is
the shipped h48 student's).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.models import quantized as jq
from scmgan_tpu_torch.models import quantized as tq
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.train.checkpoint import load_pytree

REPO = os.path.join(os.path.dirname(__file__), "..")
LATENT, ACTIONS, HIDDEN, HW = 16, 5, 16, 16
VARIANTS = ("halo", "split", "ring")
# The bf16 epilogue: both sides round dequant, bias, leaky-ReLU and the
# requant product to bf16, op by op, from the same int32 sums; XLA may keep
# an f32 value inside a fused elementwise chain where the port rounds it
# (its excess-precision default), and a bf16 rounding tie then breaks the
# other way and moves one int8 code.  Measured: every bit equal in these
# cases; held at 0.999 of the output bits.
BF16_AGREEMENT_WITH_JAX = 0.999
# JAX's own test of the variants holds the bf16 epilogue to 0.9 of the
# f32 epilogue's bits.
BF16_AGREEMENT_WITH_F32 = 0.9


def _jax_qt(qt):
    """JAX's QuantizedTransition on the port's quantized arrays."""
    return jq.QuantizedTransition(*({k: np.array(v) for k, v in d.items()}
                                    for d in (qt.weights, qt.scales, qt.biases, qt.requant)))


def _port_qt(jqt):
    """The port's QuantizedTransition on JAX's quantized arrays."""
    return tq.make_quantized(*({k: torch.from_numpy(np.array(v)) for k, v in d.items()}
                               for d in (jqt.weights, jqt.scales, jqt.biases, jqt.requant)))


def _inputs(seed, b, hw, num_actions=ACTIONS):
    rng = np.random.default_rng(seed)
    z = (rng.random((b, hw, hw, LATENT)) > 0.5).astype(np.float32)
    a = np.eye(num_actions, dtype=np.float32)[rng.integers(0, num_actions, b)]
    return z, a


def _world_model(seed, color=3):
    """A random world model at the tests' size, drawn by the port (the JAX
    package's tree: the quantization is not under test here)."""
    return twm.init_world_model(torch.Generator().manual_seed(seed), LATENT, ACTIONS, 1,
                                3, color, hidden=HIDDEN, img_size=HW)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one intra-op thread in this module (many small f64 convs
    that slow several-fold when each wakes a thread per core on a loaded
    host); exact integer sums, so the thread count changes no result."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def packings():
    """name -> (JAX QuantizedTransition, port's, z, actions): the port's
    static and calibrated quantizations of a random transition and the
    static one of the shipped h48 student, with the same inputs (B = 3 at
    16 x 16, so that JAX's per-op compiles are shared across cases)."""
    transition = _world_model(3).transition
    z, a = _inputs(0, 3, HW)
    cal_z, _ = _inputs(1, 4, HW)
    cal_a = np.eye(ACTIONS, dtype=np.float32)[np.random.default_rng(2).integers(0, ACTIONS,
                                                                                 (4, 6))]
    h48 = load_pytree(os.path.join(REPO, "pretrained_models", "minipacman_student_h48",
                                   "model-transition.npz"), "cpu")
    out = {}
    for name, qt in (("static", tq.quantize_transition(transition)),
                     ("calibrated", tq.calibrate_transition(
                         transition, torch.from_numpy(cal_z), torch.from_numpy(cal_a))),
                     ("h48_static", tq.quantize_transition(h48))):
        out[name] = (_jax_qt(qt), qt, z, a)
    return out


def _jax_variant(name, jqt, z, a, **kw):
    fn = getattr(jq, f"transition_int8_{name}")
    return np.asarray(fn(jax.tree.map(jnp.asarray, jqt), jnp.asarray(z), jnp.asarray(a), **kw))


def _port_variant(name, qt, z, a, **kw):
    fn = getattr(tq, f"transition_int8_{name}")
    return fn(qt, torch.from_numpy(z), torch.from_numpy(a), **kw).numpy()


@pytest.mark.parametrize("packing", ["static", "calibrated", "h48_static"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_f32_epilogue_is_bit_equal(packings, variant, packing):
    """halo, split and ring with the f32 epilogue: bit-equal to JAX's same
    variant, to JAX's transition_int8 and to the port's."""
    jqt, qt, z, a = packings[packing]
    ref = np.asarray(jq.transition_int8(jax.tree.map(jnp.asarray, jqt), jnp.asarray(z),
                                        jnp.asarray(a)))
    port_ref = tq.transition_int8(qt, torch.from_numpy(z), torch.from_numpy(a)).numpy()
    got = _port_variant(variant, qt, z, a, epilogue_dtype=torch.float32)
    want = _jax_variant(variant, jqt, z, a, epilogue_dtype=jnp.float32)
    assert got.dtype == np.float32 and got.shape == z.shape
    np.testing.assert_array_equal(want, ref)
    np.testing.assert_array_equal(port_ref, ref)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("packing", ["static", "calibrated"])
@pytest.mark.parametrize("variant", VARIANTS + ("int8", "int8_v2"))
def test_bf16_epilogue_matches_jax(packings, variant, packing):
    """The bf16 epilogue of each variant and of transition_int8 / _v2 (the
    plain route: the kernel has no bf16 epilogue): agreement with JAX's bf16
    output, and with the f32 epilogue as JAX's own test holds it.  The
    halo variant's default epilogue is bf16."""
    jqt, qt, z, a = packings[packing]
    name = variant.replace("int8", "").lstrip("_")
    jfn = getattr(jq, "transition_int8" + (f"_{name}" if name else ""))
    tfn = getattr(tq, "transition_int8" + (f"_{name}" if name else ""))
    jargs = (jax.tree.map(jnp.asarray, jqt), jnp.asarray(z), jnp.asarray(a))
    targs = (qt, torch.from_numpy(z), torch.from_numpy(a))
    want = np.asarray(jfn(*jargs, epilogue_dtype=jnp.bfloat16))
    got = tfn(*targs, epilogue_dtype=torch.bfloat16).numpy()
    f32 = tfn(*targs, epilogue_dtype=torch.float32).numpy()
    agree, agree_f32 = (got == want).mean(), (got == f32).mean()
    print(f"{variant} {packing}: bf16 agreement with JAX {agree:.6f}, with f32 {agree_f32:.6f}")
    assert agree >= BF16_AGREEMENT_WITH_JAX
    assert agree_f32 > BF16_AGREEMENT_WITH_F32
    if variant == "halo":
        np.testing.assert_array_equal(tfn(*targs), got)


@pytest.mark.parametrize("variant", VARIANTS)
def test_sample_head_on_jax_uniforms(packings, variant):
    """``sample=True`` with uniforms u: JAX's st_bernoulli draws
    ``uniform(key) < p``, so the port given that uniform gives JAX's bits."""
    jqt, qt, z, a = packings["calibrated"]
    key = jax.random.PRNGKey(11)
    u = np.array(jax.random.uniform(key, z.shape, jnp.float32))
    want = _jax_variant(variant, jqt, z, a, key=key, sample=True,
                        epilogue_dtype=jnp.float32)
    got = _port_variant(variant, qt, z, a, u=torch.from_numpy(u), sample=True,
                        epilogue_dtype=torch.float32)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_threshold_heads_differ_where_the_sigmoid_rounds_to_half():
    """Each variant keeps its own head: with every logit 1e-8, sigmoid
    rounds to exactly 0.5 in f32, so halo, split and transition_int8
    (``sigmoid > 0.5``) give 0 where ring and _v2 (``logits > 0``) give 1,
    on both sides."""
    hid = 16
    shapes = {"conv1": (LATENT + ACTIONS, hid), "conv2": (hid, hid), "conv3": (hid, hid),
              "conv4": (hid, hid), "conv5": (2 * hid, hid), "conv6": (2 * hid, LATENT)}
    weights = {k: np.zeros((3, 3, ci, co), np.int8) for k, (ci, co) in shapes.items()}
    scales = {k: np.ones((co,), np.float32) for k, (_, co) in shapes.items()}
    biases = {k: np.zeros((co,), np.float32) for k, (_, co) in shapes.items()}
    biases["conv6"][:] = 1e-8
    requant = {k: np.float32(1.0) for k in shapes}
    jqt = jq.QuantizedTransition(weights, scales, biases, requant)
    qt = _port_qt(jqt)
    z, a = _inputs(5, 3, HW)
    for variant, want in (("halo", 0.0), ("split", 0.0), ("ring", 1.0)):
        assert (_jax_variant(variant, jqt, z, a, epilogue_dtype=jnp.float32) == want).all()
        assert (_port_variant(variant, qt, z, a, epilogue_dtype=torch.float32) == want).all()
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    for fn, want in (("transition_int8", 0.0), ("transition_int8_v2", 1.0)):
        assert (np.asarray(getattr(jq, fn)(jqt, jnp.asarray(z), jnp.asarray(a))) == want).all()
        for ep in (torch.float32, torch.bfloat16):
            assert (getattr(tq, fn)(qt, zt, at, epilogue_dtype=ep).numpy() == want).all()


@pytest.mark.parametrize("decoder", ["random_3_colours", "random_1_colour", "minipacman_cf"])
def test_decode_int8_is_bit_equal(decoder):
    """quantize_decoder's codes and scales equal JAX's; decode_int8's f32
    logits bit-equal to JAX's (the per-factor sum in XLA's order), on random
    decoders and on minipacman_cf's trained one."""
    if decoder == "minipacman_cf":
        with np.load(os.path.join(REPO, "pretrained_models", decoder,
                                  "model-decoder.npz")) as f:
            dec = {k: {"w": f[f"{k}/w"], "b": f[f"{k}/b"]} for k in ("conv1", "conv2")}
    else:
        color = 3 if decoder == "random_3_colours" else 1
        dec = {k: {kk: vv.numpy() for kk, vv in v.items()}
               for k, v in _world_model(6 + color, color).decoder.items()}
    jqd = jq.quantize_decoder(jax.tree.map(jnp.asarray, dec))
    qd = tq.quantize_decoder({k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                              for k, v in dec.items()})
    for field in jqd._fields:
        np.testing.assert_array_equal(getattr(qd, field).numpy(),
                                      np.asarray(getattr(jqd, field)), err_msg=field)
    z, _ = _inputs(7, 3, HW)
    want = np.asarray(jq.decode_int8(jqd, jnp.asarray(z).astype(jnp.int8)))
    got = tq.decode_int8(qd, torch.from_numpy(z).to(torch.int8)).numpy()
    assert got.shape == (3, HW, HW, dec["conv2"]["w"].shape[-1] // LATENT)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
