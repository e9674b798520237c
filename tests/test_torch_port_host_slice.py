"""The host data path as a whole, the port against scmgan_tpu on the CPU at a
small width: the same hand-filled numpy episodes in both packages'
HostReplayDatasource, then ``collect``, one train step on shared weights and
``measure_prediction_mse(use_training_set=False)`` on the test split; and
the port's training loop with its evaluation hook on a replay datasource.

Tolerances: the batches are bit-equal (the same buffers and seed through
the same stitcher).  The step is test_torch_port_train_step.py's f32
deterministic-transition step, which draws nothing, so it needs no
replayed draws: the metrics agree to 1e-5 relative and the parameters as
in that file.  The
free-run's pixel MSE agrees to 1% (the port's default decoder is the
kernel's plain bf16 version on the CPU), its reward MSE to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.analysis import mse as jmse
from scmgan_tpu.config import Config as JaxConfig
from scmgan_tpu.data.replay import HostReplayDatasource as JaxReplay
from scmgan_tpu.train import trainer as jtr
from scmgan_tpu_torch.analysis import mse as tmse
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.data.replay import HostReplayDatasource
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.train import trainer as ttr
from scmgan_tpu_torch.train.losses import LossNoise
from test_torch_port_native import ensure_jax_native
from test_torch_port_train_step import (
    HW,
    NOISY_GRAD_OF_MAX,
    _assert_params_close,
    _grad_nodes,
    _jax_params,
    _jax_state,
    _port_state,
)

ACTIONS, REWARDS = 5, 2
METRIC_RTOL = 1e-5
PIXEL_RTOL = 1e-2
REWARD_RTOL, REWARD_ATOL = 1e-4, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    ensure_jax_native()


class _NoEnv:
    def __init__(self, *a, **k):
        raise AssertionError("the buffers are hand-filled; no env is made")


def _filled(cls, seed=7, **kw):
    """A datasource holding the same seeded minipacman-shaped episodes
    (CHW 3x16x16 sparse frames, 5 actions, 2 reward channels) in both
    packages: 8 train and 3 test episodes of 9-20 steps."""
    rng = np.random.default_rng(seed)
    ds = cls(_NoEnv, num_actions=ACTIONS, num_rewards=REWARDS, channels=3,
             min_buffer_len=1, max_trajectory_len=20, seed=seed, height=HW, width=HW, **kw)
    ds._ensure_started = lambda: None
    for split, n_eps in ((ds.buffer._train, 8), (ds.buffer._test, 3)):
        for _ in range(n_eps):
            n = int(rng.integers(9, 21))
            split.append(((rng.random((n, 3, HW, HW)) < 0.2).astype(np.float32),
                          rng.integers(-1, 2, (n, REWARDS)).astype(np.float32),
                          rng.integers(0, ACTIONS, n)))
    return ds


def test_slice_matches_jax(tmp_path):
    jds, tds = _filled(JaxReplay), _filled(HostReplayDatasource, device="cpu")
    horizon = 4
    jbatch = jds.collect(2, horizon)
    tbatch = tds.collect(2, horizon)
    for w, g in zip(jbatch, tbatch):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tbatch[0].shape == (2, horizon, HW, HW, 3)

    cfg_kw = dict(deterministic_transition=True, compute_dtype="float32", batch_size=2)
    cfg, jcfg = Config(**cfg_kw), JaxConfig(**cfg_kw)
    params = _jax_params()
    js, ts = _jax_state(jcfg, params), _port_state(cfg, params)
    js, jm = jtr.make_train_step(jcfg, horizon)(js, jbatch, jax.random.PRNGKey(0),
                                                jnp.float32(0.5), jnp.float32(0.0))
    ts, tm = ttr.make_train_step(cfg, horizon)(ts, tbatch, LossNoise(torch.Generator()),
                                               0.5, 0.0)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=METRIC_RTOL, err_msg=k)
    noisy = {}
    for name in twm.WorldModel._fields:
        for path, node in _grad_nodes(getattr(ts.params, name)):
            if node.grad is not None:
                g = node.grad.abs().numpy()
                noisy[f"['{name}']{path}"] = g < NOISY_GRAD_OF_MAX * g.max()
    _assert_params_close(ts.params, js.params, cfg.learning_rate, noisy)

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jmse.measure_prediction_mse(
        js.params, jds, train_iter=1, timesteps=6, batch_size=3, use_training_set=False,
        out_dir=str(tmp_path / "jax"), make_plots=False)
    with torch.no_grad():
        got = tmse.measure_prediction_mse(
            ts.params, tds, train_iter=1, timesteps=6, batch_size=3,
            use_training_set=False, out_dir=str(tmp_path / "port"), make_plots=False,
            transition_fn=lambda z, a: twm.transition(ts.params.transition, z, a))
    assert len(got[0]) == len(want[0]) > 0
    np.testing.assert_allclose(got[0], want[0], rtol=PIXEL_RTOL)
    np.testing.assert_allclose(got[2], want[2], rtol=REWARD_RTOL, atol=REWARD_ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=REWARD_RTOL, atol=REWARD_ATOL)
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    # both evaluations drew the test split: the streams are still in step
    np.testing.assert_array_equal(tds.get_trajectories(2, 5, training=False)[0],
                                  jds.get_trajectories(2, 5, training=False)[0])


def test_train_loop_on_a_replay_datasource(tmp_path):
    """``trainer.train`` takes its batches from the buffer (reseeded from the
    loop's generator) and its evaluation hook reads the test split."""
    ds = _filled(HostReplayDatasource, device="cpu")
    cfg = Config(env="host", hidden_dim=16, batch_size=2, train_iters=3, iters_per_video=3,
                 horizon_min=3, horizon_max=4)
    seen, results = [], []
    collect = ds.collect

    def spy(batch_size, timesteps, generator=None, training=True, policy="random"):
        seen.append((batch_size, timesteps, generator is not None, training))
        return collect(batch_size, timesteps, generator=generator, training=training)

    ds.collect = spy

    def eval_fn(state, it):
        results.append(tmse.measure_prediction_mse(
            state.params, ds, train_iter=it, timesteps=5, batch_size=2,
            out_dir=str(tmp_path), make_plots=False))

    losses = []
    state = ttr.train(cfg, ds, eval_fn=eval_fn,
                      log_fn=lambda i, m: losses.append(float(m["loss"])),
                      generator=torch.Generator().manual_seed(0))
    assert state.step == 4 and len(losses) == 3 and np.isfinite(losses).all()
    assert [s[3] for s in seen] == [True, True, False, True]   # eval at iteration 3
    assert all(s[2] for s in seen if s[3])                       # reseeded per batch
    assert len(results) == 1 and np.isfinite(results[0][0]).all()
