"""The port's exact resume, bundle hash and reference ``.pth`` import and
export (scmgan_tpu_torch.train.{checkpoint,torch_import,torch_export})
against scmgan_tpu's on the CPU, at hidden 16 on 16x16 frames.

A checkpoint written by one package resumes in the other: the loaded
arrays are bit-equal to the written ones, and the next step agrees with
the other package's next step to test_torch_port_train_step.py's
tolerance.  The ``.pth`` importer matches the JAX package's to the
tolerances stated at the top.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scmgan_tpu.config import Config as JaxConfig
from scmgan_tpu.train import checkpoint as jckpt
from scmgan_tpu.train import torch_export as jexport
from scmgan_tpu.train import torch_import as jimport
from scmgan_tpu.train import trainer as jtr
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.train import checkpoint as tckpt
from scmgan_tpu_torch.train import torch_export as texport
from scmgan_tpu_torch.train import torch_import as timport
from scmgan_tpu_torch.train import trainer as ttr
from scmgan_tpu_torch.train.losses import LossNoise
from test_torch_port_train_step import (
    NOISY_GRAD_OF_MAX,
    _assert_params_close,
    _batch,
    _grad_nodes,
    _jax_params,
    _torch_batch,
)

REPO = os.path.join(os.path.dirname(__file__), "..")
REFERENCE_PTH = os.path.join(REPO, "pretrained_models", "reference_ab_gridworld")
REFERENCE_PTH_PONG = os.path.join(REPO, "pretrained_models", "reference_ab_pong")
BUNDLES = sorted(os.path.dirname(p) for p in glob.glob(
    os.path.join(REPO, "pretrained_models", "*", "model-transition.npz")))
# The importer's spectral-norm u and v come out of one power iteration in
# f32 on each side (two matrix-vector products summed in other orders): a
# few ulps of a unit vector.  w and b are copies and must be exact.
SN_UV_ATOL = 1e-6
CFG_KW = dict(deterministic_transition=True, compute_dtype="float32",
              grad_clip_value=1e-3, batch_size=2)
HORIZON = 4


def _flat(tree):
    return dict(tckpt.flatten_tree(tree))


def _jax_flat(tree):
    return {jckpt._path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_state(cfg, params, step=1):
    opt = jtr.make_optimizer(cfg)
    p = jax.tree.map(jnp.asarray, params)
    return jtr.TrainState(p, opt.init(p), jnp.asarray(step, jnp.int32))


def _port_state(cfg, params, step=1):
    tp = tckpt.params_from_numpy(params, device="cpu")
    return ttr.TrainState(tp, ttr.make_optimizer(cfg, tp), step)


def _port_step(cfg, state, batch):
    """One port step; returns the new state and, per parameter path, where
    its gradient is too small for its sign to be trusted."""
    state, _ = ttr.make_train_step(cfg, HORIZON)(
        state, _torch_batch(batch), LossNoise(torch.Generator()), 0.5, 0.0)
    noisy = {}
    for name in twm.WorldModel._fields:
        for path, node in _grad_nodes(getattr(state.params, name)):
            if node.grad is not None:
                g = node.grad.abs().numpy()
                noisy[f"['{name}']{path}"] = g < NOISY_GRAD_OF_MAX * g.max()
    return state, noisy


def _jax_step(cfg, state, batch, i):
    return jtr.make_train_step(cfg, HORIZON)(
        state, batch, jax.random.PRNGKey(i), jnp.float32(0.5), jnp.float32(0.0))[0]


def _adam_leaves(opt_state):
    """optax's (count, mu, nu) per label, with the leaves of mu/nu by path."""
    out = {}
    for label, idx in (("clipped", (1, 0)), ("plain", (0,))):
        adam = opt_state.inner_states[label].inner_state
        for i in idx:
            adam = adam[i]
        out[label] = (int(adam.count), _jax_flat(adam.mu._asdict()),
                      _jax_flat(adam.nu._asdict()))
    return out


def test_jax_train_state_resumes_in_port(tmp_path):
    """JAX saves after one step; the port loads params, moments and the step
    bit for bit, and its next step agrees with JAX's next step."""
    cfg, jcfg = Config(**CFG_KW), JaxConfig(**CFG_KW)
    params = _jax_params()
    rng = np.random.default_rng(11)
    batches = [_batch(rng, 2, HORIZON) for _ in range(2)]
    js = _jax_step(jcfg, _jax_state(jcfg, params), batches[0], 0)
    jckpt.save_train_state(str(tmp_path), js)

    ts = tckpt.load_train_state(str(tmp_path), _port_state(cfg, _jax_params(seed=5)))
    assert ts.step == int(js.step) == 2
    got = _flat(tckpt.params_to_numpy(ts.params))
    for path, leaf in _jax_flat(js.params._asdict()).items():
        assert got[path].dtype == leaf.dtype
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    adam = _adam_leaves(js.opt_state)
    n_state = 0
    for name, opt in ts.optimizers.items():
        count, mu, nu = adam[tckpt.LABELS[name]]
        assert count == 1
        for path, leaf in tckpt.flatten_tree(getattr(ts.params, name)):
            if "/sn/" in f"/{path}":
                assert not mu[f"{name}/{path}"].any() and not nu[f"{name}/{path}"].any()
                continue
            st = opt.state[leaf]
            assert float(st["step"]) == count
            np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[f"{name}/{path}"])
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[f"{name}/{path}"])
            assert leaf.requires_grad
            n_state += 1
    assert n_state == sum(len(ttr.trainable_leaves(getattr(ts.params, n)))
                          for n in twm.WorldModel._fields)

    js = _jax_step(jcfg, js, batches[1], 1)
    ts, noisy = _port_step(cfg, ts, batches[1])
    assert ts.step == int(js.step) == 3
    _assert_params_close(ts.params, js.params, cfg.learning_rate, noisy)


@pytest.mark.parametrize("mode", ["plain", "finetune_reward", "model_only"])
def test_port_train_state_loads_in_jax(tmp_path, mode):
    """The port saves after one step; JAX's load_train_state reads the
    directory against its own template: the opt_state file has the key
    set, shapes and dtypes of JAX's own, the values are the port's, and
    both packages' next steps agree."""
    kw = dict(CFG_KW, finetune_reward=mode == "finetune_reward")
    cfg, jcfg = Config(**kw), JaxConfig(**kw)
    params = _jax_params()
    rng = np.random.default_rng(12)
    batches = [_batch(rng, 2, HORIZON) for _ in range(2)]
    ts, _ = _port_step(cfg, _port_state(cfg, params), batches[0])
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    if mode == "model_only":
        tckpt.save_model(str(port_dir), ts.params)
    else:
        tckpt.save_train_state(str(port_dir), ts)
    template = _jax_state(jcfg, _jax_params(seed=5), step=7)
    js = jckpt.load_train_state(str(port_dir), template)

    got = _jax_flat(js.params._asdict())
    for path, leaf in _flat(tckpt.params_to_numpy(ts.params)).items():
        np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    back = tckpt.load_train_state(str(port_dir), _port_state(cfg, _jax_params(seed=5), step=7))
    if mode == "model_only":
        assert int(js.step) == back.step == 7
        assert all(not opt.state for opt in back.optimizers.values())
        for a, b in zip(jax.tree.leaves(js.opt_state), jax.tree.leaves(template.opt_state)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return

    jckpt.save_train_state(str(jax_dir), template)
    with np.load(port_dir / "opt_state.npz") as mine, \
            np.load(jax_dir / "opt_state.npz") as theirs:
        assert sorted(mine.files) == sorted(theirs.files)
        assert len(mine.files) == (34 if mode == "finetune_reward" else 114)
        for k in theirs.files:
            assert mine[k].shape == theirs[k].shape and mine[k].dtype == theirs[k].dtype, k
    with np.load(port_dir / "step.npz") as s:
        assert s["step"].dtype == np.int32 and int(s["step"]) == 2
    assert int(js.step) == ts.step == back.step == 2
    adam = _adam_leaves(js.opt_state)
    assert adam["clipped"][0] == adam["plain"][0] == 1
    for name, opt in ts.optimizers.items():
        _, mu, nu = adam[tckpt.LABELS[name]]
        for path, leaf in tckpt.flatten_tree(getattr(ts.params, name)):
            st = opt.state.get(leaf, {})
            for key, moments in (("exp_avg", mu), ("exp_avg_sq", nu)):
                want = (st[key].numpy() if key in st
                        else np.zeros(tuple(leaf.shape), np.float32))
                np.testing.assert_array_equal(moments[f"{name}/{path}"], want)
    if mode == "finetune_reward":
        assert sorted(back.optimizers) == ["discriminator", "reward_predictor"]
    js = _jax_step(jcfg, js, batches[1], 1)
    back, noisy = _port_step(cfg, back, batches[1])
    _assert_params_close(back.params, js.params, cfg.learning_rate, noisy)


def test_unreached_networks_step_as_optax(tmp_path):
    """At horizon 3 the loss does not reach the transition, and no loss term
    reads the discriminator: optax steps them with zero gradients (one
    count per label, decayed moments), and so does the port, so that the
    file has one count per label and the next step agrees."""
    cfg, jcfg = Config(**CFG_KW), JaxConfig(**CFG_KW)
    params = _jax_params()
    rng = np.random.default_rng(13)
    batches = [_batch(rng, 2, 3), _batch(rng, 2, HORIZON)]
    ts = _port_state(cfg, params)
    ts, _ = ttr.make_train_step(cfg, 3)(ts, _torch_batch(batches[0]),
                                        LossNoise(torch.Generator()), 0.5, 0.0)
    steps = {float(st["step"]) for opt in ts.optimizers.values() for st in opt.state.values()}
    assert steps == {1.0}
    assert len(ts.optimizers["transition"].state) == len(
        ttr.trainable_leaves(ts.params.transition))
    tckpt.save_train_state(str(tmp_path), ts)
    js = jtr.make_train_step(jcfg, 3)(_jax_state(jcfg, params), batches[0],
                                      jax.random.PRNGKey(0), jnp.float32(0.5),
                                      jnp.float32(0.0))[0]
    with np.load(tmp_path / "opt_state.npz") as d:
        for label, (count, mu, _) in _adam_leaves(js.opt_state).items():
            assert int(d[f"{tckpt.ADAM_PATHS[label]}/count"]) == count == 1
            for path in ("transition/conv3/w", "discriminator/fc1/w"):
                if path in mu:
                    assert not mu[path].any()
                    assert not d[f"{tckpt.ADAM_PATHS[label]}/mu/{path}"].any()
    js = _jax_step(jcfg, js, batches[1], 1)
    ts, noisy = _port_step(cfg, ts, batches[1])
    _assert_params_close(ts.params, js.params, cfg.learning_rate, noisy)


def test_load_rejects_sn_moments_and_template_mismatches(tmp_path):
    cfg = Config(**CFG_KW)
    ts = _port_state(cfg, _jax_params())
    tckpt.save_train_state(str(tmp_path), ts)
    path = tmp_path / "opt_state.npz"
    with np.load(path) as d:
        arrays = dict(d)
    key = "inner_states/clipped/inner_state/1/0/mu/encoder/conv1/sn/u"
    arrays[key] = arrays[key] + 1.0
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="spectral-norm"):
        tckpt.load_train_state(str(tmp_path), ts)
    wide = twm.init_transition(torch.Generator().manual_seed(0), 16, 5, hidden=32)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_pytree(str(tmp_path / "model-transition.npz"), "cpu", template=wide)
    extra = tckpt.load_pytree(str(tmp_path / "model-transition.npz"), "cpu")
    extra["conv7"] = {"w": torch.zeros(1)}
    with pytest.raises(KeyError, match="conv7"):
        tckpt.load_pytree(str(tmp_path / "model-transition.npz"), "cpu", template=extra)


@pytest.mark.parametrize("bundle", BUNDLES, ids=os.path.basename)
def test_bundle_hash_matches_jax(bundle):
    assert tckpt.bundle_hash(bundle) == jckpt.bundle_hash(bundle)


@pytest.mark.parametrize("bundle", [REFERENCE_PTH, REFERENCE_PTH_PONG], ids=os.path.basename)
def test_reference_pth_import_matches_jax(bundle):
    """w and b exact; the spectral-norm u and v within SN_UV_ATOL; the same
    model through load_model's .pth branch.  gridworld (16x16) and pong
    (64x64, 3 colours: decoder conv2.weight (64, 48, 3, 3))."""
    want = _jax_flat(jimport.load_reference_checkpoint(bundle)._asdict())
    got = _flat(tckpt.params_to_numpy(
        timport.load_reference_checkpoint(bundle, device="cpu")))
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype, path
        if "/sn/" in path:
            np.testing.assert_allclose(got[path], leaf, rtol=0, atol=SN_UV_ATOL, err_msg=path)
        else:
            np.testing.assert_array_equal(got[path], leaf, err_msg=path)
    via_load = _flat(tckpt.params_to_numpy(tckpt.load_model(bundle, device="cpu")))
    for path, leaf in got.items():
        np.testing.assert_array_equal(via_load[path], leaf)


def test_reference_pth_export_matches_jax_and_round_trips(tmp_path):
    """The port's export writes the JAX package's state dicts (the same
    keys, encoder bn_conv1 buffers included, and values); importing them
    again gives back w and b exactly and u and v within SN_UV_ATOL of the
    JAX package's import of the same files."""
    params = jax.tree.map(np.asarray, _jax_params(img=64))
    texport.export_reference_checkpoint(
        tckpt.params_from_numpy(params, device="cpu"), str(tmp_path / "port"))
    jexport.export_reference_checkpoint(params, str(tmp_path / "jax"))
    for fname in timport.REFERENCE_FILES.values():
        mine = torch.load(tmp_path / "port" / fname, weights_only=True)
        theirs = torch.load(tmp_path / "jax" / fname, weights_only=True)
        assert sorted(mine) == sorted(theirs), fname
        for k in theirs:
            assert mine[k].dtype == theirs[k].dtype, (fname, k)
            torch.testing.assert_close(mine[k], theirs[k], rtol=0, atol=0)
    assert "bn_conv1.running_var" in torch.load(tmp_path / "port" / "model-encoder.pth")
    back = _flat(tckpt.params_to_numpy(
        timport.load_reference_checkpoint(str(tmp_path / "port"), device="cpu")))
    ref = _jax_flat(jimport.load_reference_checkpoint(str(tmp_path / "port"))._asdict())
    for path, leaf in _jax_flat(params._asdict()).items():
        if "/sn/" in path:
            np.testing.assert_allclose(back[path], ref[path], rtol=0, atol=SN_UV_ATOL)
        else:
            np.testing.assert_array_equal(back[path], leaf, err_msg=path)
