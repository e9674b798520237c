"""The port's int8 serving transition (scmgan_tpu_torch.models.quantized)
against scmgan_tpu.models.quantized on the CPU, on the shipped minipacman_cf
teacher (hidden 128) and minipacman_student_h48 (hidden 48).

Spectral norm: the two frameworks sum sigma = u . (W v) in another order,
so the folded weights can differ in their last bit, which moves an int8
code where a weight sits on a rounding tie.  The tests that hold the
quantization to bit equality hand both sides the same folded weights
(``same_sn``); one test bounds what the port's own spectral norm changes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.models import quantized as jq
from scmgan_tpu.ops.spectral_norm import sn_weight as jax_sn_weight
from scmgan_tpu_torch.models import quantized as tq
from scmgan_tpu_torch.train.checkpoint import load_pytree

REPO = os.path.join(os.path.dirname(__file__), "..")
BUNDLES = {"teacher": "minipacman_cf", "h48": "minipacman_student_h48"}
LATENT, ACTIONS = 16, 5
# activation ranges come from an f32 free-run whose convs sum in another
# order on each side
SCALE_RTOL = 1e-5
# below 100 the range is an order statistic from the bulk of the
# activations, where that f32 noise (up to 3e-5 absolute at these sizes) is
# a larger share of the value than at the max; on the same data the
# percentile itself is bit-equal (test_percentile_matches_jnp_percentile)
PERCENTILE_RTOL = 5e-5


@pytest.fixture(scope="module", params=sorted(BUNDLES))
def params(request):
    path = os.path.join(REPO, "pretrained_models", BUNDLES[request.param],
                        "model-transition.npz")
    return load_pytree(path, "cpu")


def _jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture
def same_sn(monkeypatch):
    """The port's quantization fed the JAX package's folded weights."""
    def sn(p):
        return torch.from_numpy(np.array(jax_sn_weight(_jax(p))))
    monkeypatch.setattr(tq, "sn_weight", sn)


def _qt_from_jax(q):
    conv = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}  # noqa: E731
    return tq.make_quantized(conv(q.weights), conv(q.scales), conv(q.biases),
                             conv(q.requant))


def _inputs(seed, b=2, hw=32, steps=None):
    rng = np.random.default_rng(seed)
    z = (rng.random((b, hw, hw, LATENT)) > 0.5).astype(np.float32)
    shape = (b,) if steps is None else (b, steps)
    a = np.eye(ACTIONS, dtype=np.float32)[rng.integers(0, ACTIONS, shape)]
    return z, a


def _assert_quantized_equal(got, want):
    for name in want.weights:
        np.testing.assert_array_equal(_np(got.weights[name]),
                                      np.asarray(want.weights[name]), err_msg=name)
        np.testing.assert_array_equal(_np(got.scales[name]),
                                      np.asarray(want.scales[name]), err_msg=name)
        np.testing.assert_array_equal(_np(got.biases[name]),
                                      np.asarray(want.biases[name]), err_msg=name)
        np.testing.assert_array_equal(_np(got.requant[name]),
                                      np.asarray(want.requant[name]), err_msg=name)


def test_quantize_matches_jax(params):
    w = params["conv2"]["w"] * 3.0
    q, s = tq._quantize(w)
    jqw, js = jq._quantize(jnp.asarray(w.numpy()))
    assert q.dtype == torch.int8 and q.shape == w.shape
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_transition_matches_jax(params, same_sn):
    got = tq.quantize_transition(params)
    want = jq.quantize_transition(_jax(params))
    _assert_quantized_equal(got, want)


def test_quantize_transition_own_spectral_norm(params):
    """Without the shared folded weights, an int8 code may differ only
    where the JAX package's weight / scale lies on a rounding tie."""
    got = tq.quantize_transition(params)
    want = jq.quantize_transition(_jax(params))
    for name in want.weights:
        w = (np.asarray(jax_sn_weight(_jax(params[name]))) if name != "conv6"
             else params[name]["w"].numpy())
        ratio = w / np.asarray(want.scales[name]) * (
            1.0 if name == "conv1" else jq.ACT_SCALE)
        diff = got.weights[name].numpy() != np.asarray(want.weights[name])
        assert diff.sum() <= 2, name
        tie = np.abs(np.abs(ratio) % 1.0 - 0.5)
        assert np.all(tie[diff] < 1e-4), name
        np.testing.assert_allclose(got.scales[name].numpy(),
                                   np.asarray(want.scales[name]), rtol=1e-6)


@pytest.mark.parametrize("percentile", [100.0, 99.9])
@pytest.mark.parametrize("steps", [None, 3], ids=["one_step", "free_run"])
def test_activation_scales_match_jax(params, steps, percentile):
    """The per-channel max, and below 100 the percentile."""
    z, a = _inputs(1, b=3, hw=32, steps=steps)
    got = tq.activation_scales(params, torch.from_numpy(z), torch.from_numpy(a),
                               percentile=percentile)
    want = jq.activation_scales(_jax(params), jnp.asarray(z), jnp.asarray(a),
                                percentile=percentile)
    assert sorted(got) == sorted(want) == ["conv1", "conv2", "conv3", "conv4",
                                           "conv5"]
    for name in want:
        np.testing.assert_allclose(
            got[name].numpy(), np.asarray(want[name]), err_msg=name,
            rtol=SCALE_RTOL if percentile >= 100.0 else PERCENTILE_RTOL)


@pytest.mark.parametrize("percentile", [99.9, 99.0, 95.0, 50.0])
def test_percentile_matches_jnp_percentile(percentile):
    """The reduction below 100 on its own, as ``activation_scales`` calls
    it, against jnp.percentile on the same |activations|: bit for bit
    (torch.quantile is up to 5e-6 relative away at 99)."""
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal((3 * 32 * 32, 128))).astype(np.float32)
    got = tq.percentile_rows(torch.from_numpy(x), percentile)
    want = jnp.percentile(jnp.asarray(x), percentile, axis=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_calibrate_fold_matches_jax(params, same_sn, monkeypatch):
    """Given the same activation scales, the fold into the next layer's
    weights and the per-channel quantization are bit-equal."""
    z, a = _inputs(2, b=2, hw=32, steps=3)
    want = jq.calibrate_transition(_jax(params), jnp.asarray(z), jnp.asarray(a))
    act = jq.activation_scales(_jax(params), jnp.asarray(z), jnp.asarray(a))
    monkeypatch.setattr(tq, "activation_scales", lambda *args, **kw: {
        k: torch.from_numpy(np.asarray(v)) for k, v in act.items()})
    got = tq.calibrate_transition(params, torch.from_numpy(z), torch.from_numpy(a))
    _assert_quantized_equal(got, want)


@pytest.mark.parametrize("calibrated", [False, True], ids=["static", "calibrated"])
@pytest.mark.parametrize("version", ["v1", "v2"])
def test_transition_int8_matches_jax(params, calibrated, version):
    """Latents bit-equal to the JAX function on the same quantized weights."""
    z, a = _inputs(3)
    jp = _jax(params)
    if calibrated:
        zc, ac = _inputs(4, b=2, hw=32, steps=3)
        jqt = jq.calibrate_transition(jp, jnp.asarray(zc), jnp.asarray(ac))
    else:
        jqt = jq.quantize_transition(jp)
    jfn, tfn = {"v1": (jq.transition_int8, tq.transition_int8),
                "v2": (jq.transition_int8_v2, tq.transition_int8_v2)}[version]
    want = np.asarray(jfn(jqt, jnp.asarray(z), jnp.asarray(a)))
    got = tfn(_qt_from_jax(jqt), torch.from_numpy(z), torch.from_numpy(a))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95


def test_transition_int8_v2_keeps_an_int8_carry(params):
    z, a = _inputs(5)
    qt = tq.quantize_transition(params)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    out = tq.transition_int8_v2(qt, zt.to(torch.int8), at)
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(),
                                  tq.transition_int8_v2(qt, zt, at).numpy())


def test_binarize_latent_thresholds_a_continuous_carry(params):
    """A carry straight off the encoder (continuous sigmoid values) is
    thresholded at 0.5, as in the JAX package, never truncated to 0."""
    rng = np.random.default_rng(6)
    z = rng.random((2, 32, 32, LATENT)).astype(np.float32)
    got = tq._binarize_latent(torch.from_numpy(z))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq._binarize_latent(jnp.asarray(z))))
    assert got.numpy().mean() > 0.4   # a truncating cast would give all zeros
    np.testing.assert_array_equal(
        tq._binarize_latent(torch.tensor([0, 1], dtype=torch.int32)).numpy(),
        [0, 1])
    _, a = _inputs(7)
    qt = tq.quantize_transition(params)
    at = torch.from_numpy(a)
    np.testing.assert_array_equal(
        tq.transition_int8_v2(qt, torch.from_numpy(z), at).numpy(),
        tq.transition_int8_v2(qt, torch.from_numpy((z > 0.5).astype(np.float32)),
                              at).numpy())
