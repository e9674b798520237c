"""The serving decoder at every latent width, on the CPU, and a latent-8
model's free-run end to end.

The decoder kernel takes any latent L and the intermediate width 4L that
``init_decoder`` gives, both zero-padded to multiples of 16.  Here, at
latents 4, 8, 32 and 64: the padded operands compute the model's function,
and the port's CPU path matches the JAX package (f32 against XLA's
``decode_fused``, bf16 against the Pallas ``fused_decode`` in interpret
mode).  Then ``measure_prediction_mse`` of a latent-8 gridworld model
(``tests/test_train.py``'s configuration) through the port's serving
wrappers on the CPU against the JAX package's.  The CUDA kernel itself is
held against its plain version at these shapes by the ``cuda``-marked tests
of test_torch_port_kernels.py and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import scmgan_tpu.ops.pallas.fused_decoder as jfd
from scmgan_tpu.analysis import mse as jmse
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu_torch.analysis import mse as tmse
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.data.datasource import allocate_datasource
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.ops.kernels import fused_decoder as tfd
from scmgan_tpu_torch.ops.kernels import fused_transition as tft

LATENTS = [4, 8, 32, 64]
COLOR = 3
# f32 against XLA: the same convs summed in another order.
RTOL = ATOL = 1e-5
# the padded operands against the model's widths: the same products plus
# exact zeros, summed in another order.
PAD_ATOL = 1e-6
# bf16 logits after a bf16 intermediate (test_torch_port_kernels.py).
BF16_TOL = 0.02
# the free-run's pixel MSE through the bf16 decoder against JAX's f32 one,
# and its reward MSE, both f32 (test_torch_port_free_run.py).
BF16_RTOL = 1e-2
FREE_RTOL, FREE_ATOL = 1e-4, 1e-7


def _decoder_params(latent, seed):
    """A random decoder in the JAX package's tree (transposed-conv HWIO
    weights, biases), from numpy: conv1 latent -> 4 latent, conv2 4 latent
    -> latent x colour."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout):
        bound = 1.0 / np.sqrt(9 * cin)
        return {"w": rng.uniform(-bound, bound, (3, 3, cin, cout)).astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    return {"conv1": conv(latent, 4 * latent), "conv2": conv(4 * latent, COLOR * latent)}


@pytest.fixture(params=LATENTS, ids=[f"l{n}" for n in LATENTS])
def case(request):
    """(torch decoder, JAX decoder, latent, latents z): the same numbers."""
    latent = request.param
    params = _decoder_params(latent, seed=latent)
    rng = np.random.default_rng(latent + 1)
    z = (rng.random((2, 8, 8, latent)) > 0.5).astype(np.float32)
    return (jax.tree.map(torch.from_numpy, params), jax.tree.map(jnp.asarray, params),
            latent, z)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call
    interp = lambda *a, **k: orig(*a, **{**k, "interpret": True})  # noqa: E731
    monkeypatch.setattr(jfd.pl, "pallas_call", interp)


def test_padded_operands_compute_the_same_function(case):
    """k1, kb1 and k2 are w1, b1 and w2 zero-padded to multiples of 16; on
    latents zero-padded the same way they give the model's logits."""
    tp, _, latent, z = case
    packed = tfd.pack_decoder_weights(tp, latent, dtype=torch.float32)
    lp, hp = packed["latent_pad"], packed["hidden_pad"]
    assert (lp, hp) == (tft.round_up(latent, 16), tft.round_up(4 * latent, 16))
    assert tuple(packed["k1"].shape) == (9, lp, hp)
    assert tuple(packed["k2"].shape) == (9, hp, COLOR)
    torch.testing.assert_close(packed["k1"][:, :latent, :4 * latent], packed["w1"],
                               rtol=0, atol=0)
    assert not packed["k1"][:, latent:].any() and not packed["k1"][:, :, 4 * latent:].any()
    torch.testing.assert_close(packed["k2"][:, :4 * latent], packed["w2"], rtol=0, atol=0)
    assert not packed["k2"][:, 4 * latent:].any()
    assert not packed["kb1"][4 * latent:].any()
    zt = torch.from_numpy(z)
    padded = dict(packed, w1=packed["k1"], b1=packed["kb1"], w2=packed["k2"])
    got = tfd.decode_plain(padded, torch.nn.functional.pad(zt, (0, lp - latent)))
    np.testing.assert_allclose(got.numpy(), tfd.decode_plain(packed, zt).numpy(),
                               rtol=0, atol=PAD_ATOL)


def test_decode_f32_matches_xla(case):
    tp, jp, latent, z = case
    packed = tfd.pack_decoder_weights(tp, latent, dtype=torch.float32)
    got = tfd.fused_decode(packed, torch.from_numpy(z)).numpy()
    want = np.asarray(jwm.decode_fused(jp, jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_decode_bf16_matches_pallas(case, pallas_interpret):
    tp, jp, latent, z = case
    want = np.asarray(jfd.fused_decode(jp, jnp.asarray(z)), np.float32)
    packed = tfd.pack_decoder_weights(tp, latent)
    before = tfd.fused_decode.launches
    got = tfd.fused_decode(packed, torch.from_numpy(z))
    assert tfd.fused_decode.launches == before   # the CPU path launches nothing
    assert got.dtype == torch.bfloat16 and got.shape == (2, 8, 8, COLOR)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL, atol=BF16_TOL)


class _Stub:
    """A datasource that hands out one fixed batch."""

    def __init__(self, batch, num_actions):
        self.batch = batch
        self.binary_input_channels = num_actions

    def collect(self, batch_size, timesteps, **kw):
        return self.batch


def test_latent8_gridworld_free_run_matches_jax(tmp_path):
    """``measure_prediction_mse`` of a latent-8 gridworld model: the port's
    serving wrappers on the CPU (the f32 transition, the bf16 decoder at
    latent 8, packed at the kernels' widths) against the JAX package's
    free-run on the same weights and trajectories."""
    cfg = Config(env="gridworld", latent_dim=8, batch_size=4, train_iters=100,
                 horizon_min=3, horizon_max=5, learning_rate=1e-3)
    ds = allocate_datasource(cfg.env, seed=0, device="cpu")
    spec, acts = ds.spec, ds.binary_input_channels
    model = twm.init_world_model(torch.Generator().manual_seed(0), cfg.latent_dim, acts,
                                 spec.num_rewards, spec.channels, spec.channels,
                                 hidden=cfg.hidden_dim, img_size=spec.height)
    jmodel = jwm.WorldModel(**{name: jax.tree.map(lambda t: t.numpy(), getattr(model, name))
                               for name in jwm.WorldModel._fields})
    batch = tuple(x.numpy() for x in ds.collect(3, 7, generator=torch.Generator().manual_seed(1)))
    pt = tft.pack_transition_weights(model.transition, 8, acts, dtype=torch.float32)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jmse.measure_prediction_mse(
        jmodel, _Stub(tuple(jnp.asarray(x) for x in batch), acts), train_iter=1,
        timesteps=7, batch_size=3, out_dir=str(tmp_path / "jax"), make_plots=False)
    got = tmse.measure_prediction_mse(
        model, _Stub(tuple(torch.from_numpy(x) for x in batch), acts), train_iter=1,
        timesteps=7, batch_size=3, out_dir=str(tmp_path / "port"), make_plots=False,
        transition_fn=lambda z, a: tft.fused_transition(pt, z, a))
    assert want is not None and got is not None and len(got[0]) == len(want[0]) > 0
    np.testing.assert_allclose(got[0], want[0], rtol=BF16_RTOL)   # pixel
    np.testing.assert_allclose(got[2], want[2], rtol=FREE_RTOL, atol=FREE_ATOL)  # reward
    np.testing.assert_allclose(got[3], want[3], rtol=FREE_RTOL, atol=FREE_ATOL)
