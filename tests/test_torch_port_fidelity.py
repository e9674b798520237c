"""The port's student fidelity gate (scmgan_tpu_torch.train.distill) and
the paths it runs, against the JAX package on the CPU: the int8 free-run
per horizon, the gate record, and the bf16 transition's plain version at
the h48 student's width against the Pallas kernel in interpret mode."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import scmgan_tpu.ops.pallas.fused_transition as jft
from scmgan_tpu.analysis import mse as jmse
from scmgan_tpu.models import quantized as jq
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.train import distill as jdistill
from scmgan_tpu_torch.analysis import mse as tmse
from scmgan_tpu_torch.models import quantized as tq
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.ops.kernels import fused_transition as tft
from scmgan_tpu_torch.train import distill as tdistill
from scmgan_tpu_torch.train.checkpoint import load_model, load_pytree

REPO = os.path.join(os.path.dirname(__file__), "..")
TEACHER = os.path.join(REPO, "pretrained_models", "minipacman_cf")
STUDENT = os.path.join(REPO, "pretrained_models", "minipacman_student_h48",
                       "model-transition.npz")
LATENT, ACTIONS = 16, 5
# As in test_torch_port_free_run.py: f32 on both sides, convs summed in
# another order.
RTOL, ATOL = 1e-4, 1e-7
# bf16 against the Pallas kernel, as in test_torch_port_kernels.py: a
# latent bit may flip only where |p - 0.5| < 0.02.
P_EDGE_BF16 = 0.02


def _jax(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def model():
    return load_model(TEACHER, device="cpu")


@pytest.fixture(scope="module")
def jax_model(model):
    return jwm.WorldModel(**{name: _jax(getattr(model, name))
                             for name in jwm.WorldModel._fields})


@pytest.fixture(scope="module")
def student():
    return load_pytree(STUDENT, "cpu")


def _batch(seed, b, t, hw=16):
    rng = np.random.default_rng(seed)
    obs = (rng.random((b, t, hw, hw, 3)) < 0.2).astype(np.float32)
    rewards = rng.integers(-1, 2, (b, t, 2)).astype(np.float32)
    dones = np.zeros((b, t), bool)
    dones[1, 6] = True                # one trajectory ends mid-run
    actions = rng.integers(0, ACTIONS, (b, t))
    return obs, rewards, dones, actions


def test_int8_free_run_matches_jax_per_horizon(model, jax_model, student):
    """The calibrated int8 student as the free-run's transition_fn, on one
    numpy batch (B = 8, T = 12), with the same quantized weights."""
    batch = _batch(0, 8, 12)
    rng = np.random.default_rng(1)
    zc = (rng.random((4, 16, 16, LATENT)) > 0.5).astype(np.float32)
    ac = np.eye(ACTIONS, dtype=np.float32)[rng.integers(0, ACTIONS, (4, 3))]
    jqt = jq.calibrate_transition(_jax(student), jnp.asarray(zc), jnp.asarray(ac))
    conv = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}  # noqa: E731
    qt = tq.make_quantized(conv(jqt.weights), conv(jqt.scales),
                           conv(jqt.biases), conv(jqt.requant))
    want = jmse._free_run_stats(
        jax_model, tuple(jnp.asarray(x) for x in batch), ACTIONS,
        transition_fn=lambda z, a: jq.transition_int8_v2(jqt, z, a).astype(
            jnp.float32))
    got = tmse._free_run_stats(
        model, tuple(torch.from_numpy(np.array(x)) for x in batch), ACTIONS,
        transition_fn=lambda z, a: tq.transition_int8_v2(qt, z, a).float(),
        decode_fn=lambda z: twm.decode(model.decoder, z))
    names = ["pixel mse", "pixel std", "reward mse", "reward std", "active"]
    for name, w, g in zip(names, want, got):
        assert g.shape == (10,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


class _Stub:
    """A datasource that hands out one fixed batch, to either framework."""

    binary_input_channels = ACTIONS
    device = torch.device("cpu")

    def __init__(self, batch):
        self.batch = batch

    def collect(self, batch_size, timesteps, **kw):
        return self.batch


def test_measure_fidelity_record_matches_jax(model, jax_model, student, tmp_path,
                                            monkeypatch):
    """Same keys and, with the port's engines packed in f32 (the JAX
    package's exact free-run computes in f32), the same teacher and student
    MSE per horizon."""
    for name in ("pack_transition_weights", "pack_decoder_weights"):
        monkeypatch.setattr(tmse, name, functools.partial(
            getattr(tmse, name), dtype=torch.float32))
    batch = _batch(2, 4, 14)
    want = jdistill.measure_fidelity(
        jax_model, _jax(student), _Stub(tuple(jnp.asarray(x) for x in batch)),
        str(tmp_path / "jax"), eval_batch_size=4, eval_timesteps=14)
    got = tdistill.measure_fidelity(
        model, student, _Stub(tuple(torch.from_numpy(np.array(x)) for x in batch)),
        str(tmp_path / "port"), eval_batch_size=4, eval_timesteps=14)
    assert sorted(got) == sorted(want) == sorted([
        "eval_batch_size", "eval_timesteps", "teacher_mse", "student_mse",
        "delta_pct", "student_int8_mse", "int8_delta_pct", "mse10_delta_pct",
        "within_1pct"])
    for key in ("teacher_mse", "student_mse", "student_int8_mse"):
        assert sorted(got[key]) == sorted(want[key]) == [3, 5, 10]
        assert np.isfinite(list(got[key].values())).all()
    for key in ("teacher_mse", "student_mse"):
        for h in want[key]:
            np.testing.assert_allclose(got[key][h], want[key][h], rtol=RTOL)
    assert got["mse10_delta_pct"] == got["int8_delta_pct"][10]
    assert got["within_1pct"] == (got["mse10_delta_pct"] <= 1.0)
    assert sorted(os.listdir(tmp_path / "port")) == ["_q", "_s", "_t"]


def test_transition_plain_h48_matches_pallas(student, monkeypatch):
    """The repaired bf16 transition at hidden 48 (the kernel's plain
    version) against the Pallas kernel in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(jft.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    rng = np.random.default_rng(3)
    z = (rng.random((2, 16, 16, LATENT)) > 0.5).astype(np.float32)
    a = np.eye(ACTIONS, dtype=np.float32)[rng.integers(0, ACTIONS, 2)]
    want = np.asarray(jft.fused_transition(_jax(student), jnp.asarray(z),
                                           jnp.asarray(a)))
    packed = tft.pack_transition_weights(student, LATENT, ACTIONS)
    assert tuple(packed["w2"].shape) == (9, 48, 48)
    assert tuple(packed["w5"].shape) == (9, 96, 48)
    zt, at = torch.from_numpy(z), torch.from_numpy(a)
    got = tft.transition_plain(packed, zt, at, dtype=torch.bfloat16).numpy()
    p = tft.transition_probs(packed, zt, at, dtype=torch.bfloat16)[..., :LATENT]
    flips = got != want
    assert flips.mean() < 1e-3
    assert np.all(np.abs(p.numpy()[flips] - 0.5) < P_EDGE_BF16)
    assert 0.05 < want.mean() < 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw", [(4, 64), (3, 12)], ids=["full", "ragged"])
def test_transition_kernel_h48_matches_plain_on_card(b, hw):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no CPU mode)")
    student = load_pytree(STUDENT, "cuda")
    packed = tft.pack_transition_weights(student, LATENT, ACTIONS)
    rng = np.random.default_rng(4)
    z = torch.from_numpy((rng.random((b, hw, hw, LATENT)) > 0.5).astype(
        np.float32)).cuda()
    a = torch.from_numpy(np.eye(ACTIONS, dtype=np.float32)[
        rng.integers(0, ACTIONS, b)]).cuda()
    got = tft.fused_transition(packed, z, a)
    want = tft.transition_plain(packed, z, a, dtype=torch.bfloat16)
    p = tft.transition_probs(packed, z, a, dtype=torch.bfloat16)[..., :LATENT]
    flips = got != want
    assert float(flips.float().mean()) < 1e-3
    assert bool(((p[flips] - 0.5).abs() < P_EDGE_BF16).all())
