"""The port's dp = 4 x tp = 2 train step in eight spawned gloo processes
(hidden 32, every objective), the counterpart of MULTICHIP_r05.json's JAX
step on a 4 x 2 virtual mesh: the unsharded port step's loss and
parameters at JAX's sharding-test tolerances, and each process's shards
of ``leaf_spec``'s shapes; in the same group, a sharded checkpoint that the
first process alone writes, which loads back into a sharded state, into
the unsharded port and into the JAX package.  And ``parallel.distributed``
in a plain process.
"""

import jax
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from scmgan_tpu.config import Config as JaxConfig
from scmgan_tpu.train import checkpoint as jckpt
from scmgan_tpu.train import trainer as jtr
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.envs import get_env
from scmgan_tpu_torch.parallel import distributed
from scmgan_tpu_torch.parallel.mesh import leaf_spec
from scmgan_tpu_torch.train import checkpoint as tckpt
from scmgan_tpu_torch.train import trainer as ttr
from test_torch_parallel_step import (
    CF_ACTIVE,
    CFG,
    HORIZON,
    LOSS_RTOL,
    PARAM_ATOL,
    PARAM_RTOL,
    THETA,
    _batch,
    _jax_params,
    _port_unsharded,
)
from test_torch_port_train_loss import JaxKeyNoise

SHAPE, HIDDEN = (4, 2), 32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, batch = _jax_params(HIDDEN), _batch()
    recorder = W.RecordingNoise(JaxKeyNoise(jax.random.PRNGKey(0), HORIZON))
    unsharded = _port_unsharded(params, batch, recorder, HIDDEN)
    cfg_kw = {**CFG, "hidden_dim": HIDDEN}
    ckpt_dir = str(tmp_path_factory.mktemp("sharded_ckpt"))
    jobs = [("step", "sharded_step", dict(
                params=params, cfg_kw=cfg_kw, batch=batch, horizon=HORIZON,
                draws=recorder.draws, theta=THETA, cf_active=CF_ACTIVE)),
            ("ckpt", "checkpoint_round_trip", dict(params=params, cfg_kw=cfg_kw,
                                                   out_dir=ckpt_dir))]
    ranks = W.Group(8, SHAPE, jobs, str(tmp_path_factory.mktemp("group4x2"))).results()
    return {"unsharded": unsharded, "ranks": ranks, "ckpt_dir": ckpt_dir}


def test_4x2_step_matches_unsharded(runs):
    um, uflat = runs["unsharded"]
    ranks = [r["step"] for r in runs["ranks"]]
    assert [r["rows"] for r in ranks] == [(2, 2 * (i // 2)) for i in range(8)]
    assert um["lo_loss"] > 0.0
    for r in ranks:
        for k in um:
            np.testing.assert_allclose(r["metrics"][k], um[k], rtol=LOSS_RTOL, err_msg=k)
        for path, leaf in uflat.items():
            np.testing.assert_allclose(r["full"][path], leaf, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=path)
        assert r["step"] == 2


def test_4x2_shards_have_leaf_spec_shapes(runs):
    ranks = [r["step"] for r in runs["ranks"]]
    n_sharded = 0
    for path, leaf in ranks[0]["full"].items():
        dim = leaf_spec(leaf.shape, 2, "model")
        for rank, r in enumerate(ranks):
            shard = r["shards"][path]
            want = leaf if dim is None else np.split(leaf, 2, axis=-1)[rank % 2]
            np.testing.assert_array_equal(shard, want, err_msg=path)
            if path in r["moments"]:
                assert r["moments"][path][0].shape == want.shape, path
        n_sharded += dim is not None
    assert n_sharded > 40


def test_sharded_checkpoint_written_once_and_loads(runs):
    ranks = [r["ckpt"] for r in runs["ranks"]]
    assert ranks[0]["writes"] == sorted(
        [*tckpt.MODEL_FILES.values(), tckpt.OPT_FILE, tckpt.STEP_FILE])
    assert all(r["writes"] == [] for r in ranks[1:])
    for r in ranks:
        assert r["same"] and r["n"] > 0 and r["sharded"] and r["step"] == 3
    # the whole state: in the unsharded port, and in the JAX package
    cfg = Config(**CFG, hidden_dim=HIDDEN)
    full = tckpt.load_train_state(runs["ckpt_dir"], ttr.init_train_state(
        cfg, get_env("gridworld"), torch.Generator().manual_seed(0)))
    assert full.step == 3 and full.shardings is None
    assert all(float(st["step"]) == 2.0 for opt in full.optimizers.values()
               for st in opt.state.values())
    back = jckpt.load_train_state(runs["ckpt_dir"], jtr.init_train_state(
        JaxConfig(**CFG, hidden_dim=HIDDEN), get_env("gridworld"), jax.random.PRNGKey(0)))
    assert int(back.step) == 3
    mine = W._world_flat(full.params)
    for k, v in jax.tree_util.tree_flatten_with_path(back.params._asdict())[0]:
        np.testing.assert_array_equal(np.asarray(v), mine[jckpt._path_str(k)])


def test_initialize_is_a_no_op_alone(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "SCMGAN_INIT_METHOD"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()


def test_process_batch_slice_alone():
    assert distributed.process_batch_slice(32) == (32, 0)
    assert distributed.process_batch_slice(7) == (7, 0)
    assert distributed.local_device_count() >= 1
