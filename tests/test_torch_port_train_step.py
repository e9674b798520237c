"""The port's training step against scmgan_tpu's on the CPU: parameter
init, the spectral-norm refresh, the per-network Adam with value clipping,
``finetune_reward``, the curriculum schedules of ``train()``, the loop on
the minipacman datasource, and a port-trained bundle loaded by the JAX
package.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.config import Config as JaxConfig
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.ops import spectral_norm as jsn
from scmgan_tpu.train import checkpoint as jckpt
from scmgan_tpu.train import trainer as jtr
from scmgan_tpu_torch.analysis.mse import measure_prediction_mse
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.data.datasource import allocate_datasource
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.ops import spectral_norm as tsn
from scmgan_tpu_torch.train import checkpoint as tckpt
from scmgan_tpu_torch.train import trainer as ttr
from scmgan_tpu_torch.train.losses import LossNoise

HW = 16
# The power iteration in f32: the two frameworks sum the matrix-vector
# products in other orders, a few ulps of a unit vector.
SN_ATOL = 1e-6
# After Adam, a parameter moves by about lr per step whatever the gradient's
# size (lr * m_hat / (sqrt(v_hat) + eps)), so two steps agree to the
# rounding of that ratio: 1e-3 of a step (lr = 1e-4) plus the f32 ulp of
# the parameter.  Where the gradient is at the level of the two
# frameworks' gradient difference (|g| below 1e-4 of the leaf's largest
# entry), its sign can differ and the move by up to 2 * lr a step.
STEP_ATOL_OF_LR = 1e-3
NOISY_GRAD_OF_MAX = 1e-4


def _jax_params(hidden=16, img=HW, seed=1):
    return jax.tree.map(np.asarray, jwm.init_world_model(
        jax.random.PRNGKey(seed), 16, 5, 2, 3, 3, hidden=hidden, img_size=img))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def test_config_matches_jax():
    ours = {f.name: f.default for f in dataclasses.fields(Config)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs
    assert Config().pdtype == torch.float32 and Config().cdtype == torch.bfloat16


def test_init_world_model_matches_jax_tree_and_bounds():
    g = torch.Generator().manual_seed(0)
    ours = twm.init_world_model(g, 16, 5, 2, 3, 3, hidden=32, img_size=(64, 48))
    theirs = jwm.init_world_model(jax.random.PRNGKey(0), 16, 5, 2, 3, 3,
                                  hidden=32, img_size=(64, 48))
    mine = _leaves(tckpt.params_to_numpy(ours))
    want = _leaves(theirs._asdict())
    assert list(mine) == list(want)
    for path, leaf in want.items():
        assert mine[path].shape == leaf.shape and mine[path].dtype == leaf.dtype, path
    # every weight and bias within torch's default U(-b, b)
    fan = {"conv": lambda w: w.shape[0] * w.shape[1] * w.shape[2],
           "convT": lambda w: w.shape[0] * w.shape[1] * w.shape[3],
           "linear": lambda w: w.shape[0]}
    for name in twm.WorldModel._fields:
        for layer, node in getattr(ours, name).items():
            kind = ("convT" if name == "decoder" else
                    "linear" if layer == "fc1" else "conv")
            bound = 1.0 / math.sqrt(fan[kind](node["w"]))
            assert float(node["w"].abs().max()) <= bound, (name, layer)
            assert float(node["b"].abs().max()) <= bound, (name, layer)
            assert float(node["w"].abs().max()) > 0.9 * bound, (name, layer)


def test_sn_init_estimates_the_spectral_norm():
    """sigma = u.Wv after sn_init's 10 warm-up iterations: never above the
    largest singular value; within 10% of it for a uniform init (its
    spectrum has no gap, so the power iteration converges slowly: 0.93-0.999
    over 30 such weights), and to 1e-4 for a weight with a clear gap."""
    g = torch.Generator().manual_seed(3)
    params = twm.init_world_model(g, 16, 5, 2, 3, 3, hidden=64)
    gapped = torch.randn(3, 3, 16, 32, generator=g) * 0.01
    gapped += torch.einsum("i,j->ij", torch.randn(144, generator=g),
                           torch.randn(32, generator=g)).reshape(3, 3, 16, 32)
    nodes = [n for net in params for n in net.values() if "sn" in n]
    nodes.append({"w": gapped, "sn": tsn.sn_init(g, gapped)})
    for i, node in enumerate(nodes):
        m = node["w"].reshape(-1, node["w"].shape[-1]).T
        sigma = float(node["sn"]["u"] @ m @ node["sn"]["v"])
        top = float(torch.linalg.svdvals(m)[0])
        assert sigma <= top * (1 + 1e-5)
        assert sigma >= top * (0.9999 if i == len(nodes) - 1 else 0.9)
        assert not node["sn"]["u"].requires_grad
        assert not node["sn"]["v"].requires_grad


def test_discriminate_matches_jax():
    params = _jax_params(hidden=16, img=64)
    x = np.random.default_rng(9).random((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jwm.discriminate(params.discriminator, jnp.asarray(x)))
    got = twm.discriminate(tckpt.params_from_numpy(params, device="cpu").discriminator,
                           torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_update_spectral_norms_matches_jax():
    params = _jax_params(hidden=32)
    # move the weights off the point where u/v were converged
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(x.dtype),
                          params)
    want = _leaves(jwm.WorldModel(*jsn.update_spectral_norms(params))._asdict())
    ours = tckpt.params_from_numpy(params, device="cpu")
    before = {id(x) for net in ours for x in ttr.trainable_leaves(net)}
    old_u = ours.transition["conv1"]["sn"]["u"].clone()
    new = tsn.update_spectral_norms(ours)
    got = _leaves(tckpt.params_to_numpy(new))
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, rtol=0, atol=SN_ATOL, err_msg=path)
    n_sn = sum("sn" in path for path in want)
    assert n_sn == 2 * 10   # encoder 3, transition 5, discriminator 2
    # new u/v; the tensors the forward read are untouched; w and b are the
    # same objects (Adam's references stay valid)
    torch.testing.assert_close(ours.transition["conv1"]["sn"]["u"], old_u, rtol=0, atol=0)
    assert new.transition["conv1"]["sn"]["u"] is not ours.transition["conv1"]["sn"]["u"]
    assert {id(x) for net in new for x in ttr.trainable_leaves(net)} == before


def test_horizon_loss_config_and_loop_schedule_match_jax(monkeypatch):
    """horizon_at and loss_config exactly; and the loop's order: hooks
    before the step of every iters_per_video-th iteration, then the
    iteration's horizon, theta and cf_active, as JAX's loop calls them."""
    kw = dict(train_iters=24, iters_per_video=6, cf_regularization_rate=5,
              enable_disentanglement_loss=True, counterfactual_horizon=2,
              latent_td=True, truncate_bptt=True)
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    for it in range(1, 25):
        assert ttr.horizon_at(cfg, it) == jtr.horizon_at(jcfg, it)
        h = ttr.horizon_at(cfg, it)
        assert ttr.loss_config(cfg, h)._asdict() == jtr.loss_config(jcfg, h)._asdict()
    assert [ttr.horizon_at(cfg, it) for it in (1, 24)] == [3, 10]

    def run(module, cfg, collect_kw, state):
        events = []

        def make_step(cfg, horizon, *rest):
            def step(state, batch, noise_or_key, theta, cf_active):
                # JAX hands theta over as float32; the port's loss makes it
                # an f32 tensor
                events.append(("step", batch, np.float32(theta), np.float32(cf_active)))
                return state, {"loss": 0.0}
            return step

        class Source:
            device = torch.device("cpu")
            spec = None

            def collect(self, b, horizon, **kw):
                assert set(kw) == {collect_kw}
                return horizon

        monkeypatch.setattr(module, "make_train_step", make_step)
        module.train(cfg, Source(), state,
                     eval_fn=lambda s, i: events.append(("eval", i)),
                     checkpoint_fn=lambda s, i: events.append(("ckpt", i)),
                     log_fn=lambda i, m: events.append(("log", i)))
        return events

    ours = run(ttr, cfg, "generator", "state")
    theirs = run(jtr, jcfg, "key", "state")
    assert ours == theirs
    assert [e[1] for e in ours if e[0] == "eval"] == [6, 12, 18, 24]
    assert [e[3] for e in ours if e[0] == "step"].count(1.0) == 4   # 5, 10, 15, 20


def _jax_state(cfg, params):
    opt = jtr.make_optimizer(cfg)
    p = jax.tree.map(jnp.asarray, params)
    return jtr.TrainState(p, opt.init(p), jnp.asarray(1, jnp.int32))


def _port_state(cfg, params):
    tp = tckpt.params_from_numpy(params, device="cpu")
    return ttr.TrainState(tp, ttr.make_optimizer(cfg, tp), 1)


def _batch(rng, b, t):
    obs = (rng.random((b, t, HW, HW, 3)) > 0.7).astype(np.float32)
    rewards = rng.integers(-1, 2, (b, t, 2)).astype(np.float32)
    dones = np.zeros((b, t), bool)
    actions = rng.integers(0, 5, (b, t))
    return obs, rewards, dones, actions


def _torch_batch(batch):
    return tuple(torch.from_numpy(np.asarray(x)) for x in batch)


def _assert_params_close(port_params, jax_params, lr, noisy):
    got = _leaves(tckpt.params_to_numpy(port_params))
    want = _leaves(jax.tree.map(np.asarray, jax_params._asdict()))
    for path, leaf in want.items():
        limit = STEP_ATOL_OF_LR * lr + 1e-7 * np.abs(leaf)
        if path in noisy:
            limit = np.where(noisy[path], 2 * lr * 3, limit)
        err = np.abs(got[path] - leaf)
        assert np.all(err <= (SN_ATOL if "'sn'" in path else limit)), (
            path, float(err.max()))


def test_three_train_steps_match_jax():
    """Three steps, deterministic transition, f32: loss, value clip (set at
    1e-3, so that it binds), per-network Adam and the SN refresh."""
    cfg_kw = dict(deterministic_transition=True, compute_dtype="float32",
                  grad_clip_value=1e-3, batch_size=2)
    cfg, jcfg = Config(**cfg_kw), JaxConfig(**cfg_kw)
    horizon = 4
    params = _jax_params()
    js, ts = _jax_state(jcfg, params), _port_state(cfg, params)
    jstep = jtr.make_train_step(jcfg, horizon)
    tstep = ttr.make_train_step(cfg, horizon)
    rng = np.random.default_rng(4)
    noisy, clipped = {}, 0
    for i in range(3):
        batch = _batch(rng, 2, horizon)
        js, jm = jstep(js, batch, jax.random.PRNGKey(i), jnp.float32(0.5), jnp.float32(0.0))
        ts, tm = tstep(ts, _torch_batch(batch), LossNoise(torch.Generator()), 0.5, 0.0)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        for name in twm.WorldModel._fields:
            for path, node in _grad_nodes(getattr(ts.params, name)):
                if node.grad is None:
                    continue
                g = node.grad.abs().numpy()
                key = f"['{name}']{path}"
                noisy[key] = noisy.get(key, False) | (g < NOISY_GRAD_OF_MAX * g.max())
                if name in ttr.CLIPPED:
                    clipped += int((g == cfg.grad_clip_value).sum())
                    assert g.max() <= cfg.grad_clip_value
        _assert_params_close(ts.params, js.params, cfg.learning_rate, noisy)
    assert ts.step == int(js.step) == 4
    assert clipped > 0


def _grad_nodes(tree, prefix=""):
    for k, v in tree.items():
        if k == "sn":
            continue
        if isinstance(v, dict):
            yield from _grad_nodes(v, f"{prefix}['{k}']")
        else:
            yield f"{prefix}['{k}']", v


def test_finetune_reward_freezes_the_world_model():
    cfg_kw = dict(finetune_reward=True, compute_dtype="float32", batch_size=2)
    cfg, jcfg = Config(**cfg_kw), JaxConfig(**cfg_kw)
    params = _jax_params()
    ts = _port_state(cfg, params)
    assert sorted(ts.optimizers) == ["discriminator", "reward_predictor"]
    before = tckpt.params_to_numpy(ts.params)
    batch = _batch(np.random.default_rng(5), 2, 3)
    ts, _ = ttr.make_train_step(cfg, 3)(ts, _torch_batch(batch),
                                        LossNoise(torch.Generator().manual_seed(0)),
                                        0.5, 0.0)
    after = tckpt.params_to_numpy(ts.params)
    for name in ttr.CLIPPED:
        for path, leaf in _leaves(before[name]).items():
            if "'sn'" not in path:
                np.testing.assert_array_equal(_leaves(after[name])[path], leaf, err_msg=path)
    assert not np.array_equal(after["reward_predictor"]["conv1"]["w"],
                              before["reward_predictor"]["conv1"]["w"])
    # JAX's frozen networks: the same weights after its step
    js = _jax_state(jcfg, params)
    js, _ = jtr.make_train_step(jcfg, 3)(js, batch, jax.random.PRNGKey(0),
                                         jnp.float32(0.5), jnp.float32(0.0))
    for name in ttr.CLIPPED:
        for path, leaf in _leaves(getattr(js.params, name)).items():
            if "'sn'" not in path:
                np.testing.assert_array_equal(_leaves(after[name])[path], leaf)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Three port iterations at hidden 16 on the CPU minipacman datasource,
    with both CF terms (firing at iteration 2) and the evaluation and
    checkpoint hooks at iteration 2."""
    cfg = Config(env="minipacman", hidden_dim=16, batch_size=2, train_iters=3,
                 horizon_min=3, horizon_max=4, iters_per_video=2,
                 cf_regularization_rate=2, enable_disentanglement_loss=True,
                 enable_action_control_loss=True, counterfactual_horizon=2,
                 eval_batch_size=2, eval_timesteps=6)
    ds = allocate_datasource("minipacman", seed=0, device="cpu")
    out = tmp_path_factory.mktemp("train")
    events, logs = [], []

    def eval_fn(state, it):
        curves = measure_prediction_mse(state.params, ds, train_iter=it,
                                        batch_size=cfg.eval_batch_size,
                                        timesteps=cfg.eval_timesteps,
                                        out_dir=str(out), make_plots=False)
        events.append(("eval", it, curves))

    def checkpoint_fn(state, it):
        tckpt.save_model(str(out / f"ckpt{it}"), state.params)
        events.append(("ckpt", it))

    state = ttr.train(cfg, ds, eval_fn=eval_fn, checkpoint_fn=checkpoint_fn,
                      log_fn=lambda it, m: logs.append((it, {k: float(v) for k, v in m.items()})),
                      generator=torch.Generator().manual_seed(0))
    return cfg, state, events, logs, out


def test_train_loop_runs_with_hooks(trained):
    cfg, state, events, logs, out = trained
    assert [e[:2] for e in events] == [("eval", 2), ("ckpt", 2)]
    assert np.isfinite(events[0][2][0]).all()
    assert [it for it, _ in logs] == [1, 2, 3]
    for it, metrics in logs:
        assert all(np.isfinite(v) for v in metrics.values()), metrics
        assert ("cf_control_loss" in metrics) and ("cf_disentanglement_loss" in metrics)
    assert state.step == 4
    assert (out / "mse_pixel_iter_000002.json").exists()


def test_port_bundle_loads_in_jax(trained, tmp_path):
    cfg, state, _, _, _ = trained
    tckpt.save_model(str(tmp_path), state.params)
    # the port's loader reads it back bit for bit
    back = tckpt.load_model(str(tmp_path), device="cpu")
    mine = _leaves(tckpt.params_to_numpy(state.params))
    for path, leaf in _leaves(tckpt.params_to_numpy(back)).items():
        np.testing.assert_array_equal(leaf, mine[path], err_msg=path)
    # the JAX package's loader reads it, and its forwards agree with ours
    template = jwm.init_world_model(jax.random.PRNGKey(0), 16, 5, 2, 3, 3,
                                    hidden=cfg.hidden_dim, img_size=64)
    jp = jckpt.load_model(str(tmp_path), template)
    for path, leaf in _leaves(jp._asdict()).items():
        np.testing.assert_array_equal(np.asarray(leaf), mine[path], err_msg=path)
    rng = np.random.default_rng(8)
    frames = rng.random((2, 3, 64, 64, 3)).astype(np.float32)
    z_j = np.asarray(jwm.encode(jp.encoder, jnp.asarray(frames)))
    z_t = twm.encode(back.encoder, torch.from_numpy(frames)).detach().numpy()
    np.testing.assert_allclose(z_t, z_j, rtol=1e-5, atol=1e-5)
    z = (z_j > 0.5).astype(np.float32)
    a = np.eye(5, dtype=np.float32)[[0, 3]]
    nz_j = np.asarray(jwm.transition(jp.transition, jnp.asarray(z), jnp.asarray(a),
                                     train=True, deterministic=True))
    nz_t = twm.transition(back.transition, torch.from_numpy(z), torch.from_numpy(a),
                          train=True, deterministic=True).detach().numpy()
    np.testing.assert_allclose(nz_t, nz_j, rtol=1e-5, atol=1e-6)
