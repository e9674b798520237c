"""The port's sharded train step (``scmgan_tpu_torch.parallel``) against the
JAX package's on the CPU.

JAX runs its sharded step on the conftest's virtual CPU devices; the port
runs one process per device in spawned gloo groups
(``torch_parallel_workers.Group``).  Both take JAX's initial parameters
(as numpy), the same batch and JAX's key schedule (the port replays the
global draws, each process keeps its rows), in f32, with every objective
of ``__graft_entry__.dryrun_multichip``: truncated BPTT, latent
overshooting, both CF regularizers with 2-step roll-outs, firing.

Meshes (2, 1) and (1, 2) here and (2, 2) in
test_torch_parallel_step_2x2.py against JAX's on its first 2 or 4
devices, at JAX's own test tolerances (tests/test_sharding.py), at hidden
32 (JAX's sharded step at hidden 128 takes 46 s to execute on the virtual
devices); each process's shards and Adam moments have ``leaf_spec``'s
shapes and, concatenated, equal JAX's full leaves; (2, 1) equals the
port's unsharded step within the same tolerances and (1, 2) bit for bit
(one thread per process on both sides: a conv's weight gradient sums its
partial products in another order under another thread count).  The
(1, 2) and (2, 2) groups also run the spatial transition, bit-equal to
JAX's ``transition(train=False)``, and the (2, 2) group
``process_batch_slice``.  JAX's sharded steps run in threads while the
port's groups run.
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from scmgan_tpu.config import Config as JaxConfig
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.parallel import make_mesh as jax_make_mesh
from scmgan_tpu.parallel.mesh import leaf_spec as jax_leaf_spec
from scmgan_tpu.train import checkpoint as jckpt
from scmgan_tpu.train import trainer as jtr
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.envs import get_env
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.parallel.mesh import leaf_spec
from scmgan_tpu_torch.train import checkpoint as tckpt
from scmgan_tpu_torch.train import trainer as ttr
from test_torch_port_train_loss import JaxKeyNoise

B, HORIZON, LATENT = 8, 6, 8
THETA, CF_ACTIVE = 0.5, 1.0
CFG = dict(env="gridworld", latent_dim=LATENT, batch_size=B, train_iters=10,
           horizon_min=HORIZON, horizon_max=HORIZON, truncate_bptt=True,
           latent_overshooting=True, enable_disentanglement_loss=True,
           enable_action_control_loss=True, counterfactual_horizon=2,
           compute_dtype="float32")
# JAX's tolerances (tests/test_sharding.py::test_lo_dp_matches_single_device_numerics)
LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-5
HIDDEN = 32
# (2, 2) runs in test_torch_parallel_step_2x2.py, which imports these
# helpers: the two files' JAX compiles then run on two test workers
HERE = ((2, 1), (1, 2))
SPATIAL_B, SPATIAL_HW = 4, 16
# trainer.train on a host datasource stand-in, two iterations
HOST_CFG = {**CFG, "hidden_dim": HIDDEN, "start_iter": 1, "train_iters": 2,
            "cf_regularization_rate": 2}


def _jax_params(hidden):
    spec = get_env("gridworld")
    return jax.tree.map(np.asarray, jwm.init_world_model(
        jax.random.PRNGKey(2), LATENT, spec.num_actions, spec.num_rewards,
        spec.channels, spec.channels, hidden=hidden, img_size=spec.height))


def _batch():
    spec = get_env("gridworld")
    rng = np.random.default_rng(0)
    obs = (rng.random((B, HORIZON + 1, 16, 16, spec.channels)) > 0.7).astype(np.float32)
    rewards = rng.integers(-1, 2, (B, HORIZON + 1, spec.num_rewards)).astype(np.float32)
    dones = np.zeros((B, HORIZON + 1), bool)
    dones[3, 4] = True
    actions = rng.integers(0, spec.num_actions, (B, HORIZON + 1))
    return obs, rewards, dones, actions


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _port_unsharded(params, batch, noise, hidden):
    cfg = Config(**CFG, hidden_dim=hidden)
    tp = tckpt.params_from_numpy(params, device="cpu")
    state = ttr.TrainState(tp, ttr.make_optimizer(cfg, tp), 1)
    with _one_thread():
        state, metrics = ttr.make_train_step(cfg, HORIZON)(
            state, tuple(torch.from_numpy(np.asarray(x)) for x in batch), noise,
            THETA, CF_ACTIVE)
    return {k: float(v) for k, v in metrics.items()}, W._world_flat(state.params)


def _jax_sharded(params, batch, shape, out):
    try:
        _jax_sharded_step(params, batch, shape, out)
    except BaseException as e:   # noqa: BLE001 -- re-raised by the fixture
        out[shape] = e


def _jax_sharded_step(params, batch, shape, out):
    jcfg = JaxConfig(**CFG, hidden_dim=HIDDEN)
    p = jax.tree.map(jnp.asarray, params)
    state = jtr.TrainState(p, jtr.make_optimizer(jcfg).init(p), jnp.asarray(1, jnp.int32))
    mesh = jax_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    step = jtr.make_train_step.__wrapped__(jcfg, HORIZON, mesh)
    state, metrics = step(state, batch, jax.random.PRNGKey(0), jnp.float32(THETA),
                          jnp.float32(CF_ACTIVE))
    flat = {jckpt._path_str(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(state.params._asdict())[0]}
    opt = {jckpt._path_str(k): np.asarray(v) for k, v in
           jax.tree_util.tree_flatten_with_path(state.opt_state)[0]}
    out[shape] = ({k: float(v) for k, v in metrics.items()}, flat, opt)


def _spatial_case():
    """JAX's transition (hidden 128) and a binary latent batch, 16x16, B = 4."""
    key = jax.random.PRNGKey(0)
    wm = jwm.init_world_model(key, 8, 4, 1, 3, 3, img_size=SPATIAL_HW)
    z = (jax.random.uniform(key, (SPATIAL_B, SPATIAL_HW, SPATIAL_HW, 8)) > 0.5
         ).astype(jnp.float32)
    a = jax.nn.one_hot(jnp.arange(SPATIAL_B) % 4, 4)
    ref = np.asarray(jwm.transition(wm.transition, z, a, train=False))
    params = jax.tree.map(np.asarray, wm.transition)
    return params, np.asarray(z), np.asarray(a), ref


def run_meshes(tmp_path_factory, meshes):
    """The port's groups on ``meshes`` (all started at once) and JAX's
    sharded step on each (in threads meanwhile): every process's results,
    JAX's, the port's unsharded step and the spatial reference."""
    params, batch = _jax_params(HIDDEN), _batch()
    recorder = W.RecordingNoise(JaxKeyNoise(jax.random.PRNGKey(0), HORIZON))
    unsharded = _port_unsharded(params, batch, recorder, HIDDEN)
    sp_params, sp_z, sp_a, sp_ref = _spatial_case()
    step = ("step", "sharded_step", dict(
        params=params, cfg_kw={**CFG, "hidden_dim": HIDDEN}, batch=batch,
        horizon=HORIZON, draws=recorder.draws, theta=THETA, cf_active=CF_ACTIVE))
    spatial = ("spatial", "spatial", dict(params=sp_params, z=sp_z, a=sp_a))
    host = ("host", "host_train", dict(params=params, cfg_kw=HOST_CFG))
    jobs = {(2, 1): [step], (1, 2): [step, spatial, host],
            (2, 2): [step, spatial, ("slices", "batch_slices", {})]}
    groups = {shape: W.Group(shape[0] * shape[1], shape, jobs[shape],
                             str(tmp_path_factory.mktemp(f"group{shape[0]}x{shape[1]}")))
              for shape in meshes}
    jax_out = {}
    threads = [threading.Thread(target=_jax_sharded, args=(params, batch, s, jax_out))
               for s in meshes]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    port = {shape: g.results() for shape, g in groups.items()}
    for res in jax_out.values():
        if isinstance(res, BaseException):
            raise res
    assert set(jax_out) == set(meshes), sorted(jax_out)
    return {"unsharded": unsharded, "port": port, "jax": jax_out,
            "spatial_ref": sp_ref}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_meshes(tmp_path_factory, HERE)


@pytest.mark.parametrize("model_size", [2, 3, 4])
def test_leaf_spec_matches_jax(model_size):
    """Every leaf of a hidden-128 world model, and JAX's table."""
    g = torch.Generator().manual_seed(0)
    tree = twm.init_world_model(g, 16, 5, 2, 3, 3, hidden=128)
    shapes = [tuple(v.shape) for name in tree._fields
              for _, v in tckpt.flatten_tree(getattr(tree, name))]
    shapes += [(3, 3, 16, 128), (3, 3, 16, 127), (128,), (64, 32), (), (3, 3, 16, 3)]
    for shape in shapes:
        spec = jax_leaf_spec(shape, model_size, "model")
        want = next((d for d, axis in enumerate(spec) if axis == "model"), None)
        assert leaf_spec(shape, model_size, "model") == want, shape
    assert leaf_spec((3, 3, 16, 128), 1, "model") is None


def check_matches_jax(runs, shape):
    jm, jflat, _ = runs["jax"][shape]
    ranks = [r["step"] for r in runs["port"][shape]]
    assert jm["lo_loss"] > 0.0
    for r in ranks:
        assert r["metrics"].keys() == jm.keys()
        for k in jm:
            np.testing.assert_allclose(r["metrics"][k], jm[k], rtol=LOSS_RTOL, err_msg=k)
        for path, leaf in jflat.items():
            np.testing.assert_allclose(r["full"][path], leaf, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL, err_msg=path)
        assert r["step"] == 2


def check_shards(runs, shape):
    """Each process's parameter and moment shards: leaf_spec's shape, this
    process's slice of the gathered leaf; the moments, concatenated over
    'model', JAX's mu and nu (meshes JAX ran)."""
    d, m = shape
    ranks = [r["step"] for r in runs["port"][shape]]
    full = ranks[0]["full"]
    jax_opt = runs["jax"][shape][2]
    for path, leaf in full.items():
        dim = leaf_spec(leaf.shape, m, "model")
        for rank, r in enumerate(ranks):
            shard = r["shards"][path]
            assert r["specs"][path] == ([] if dim is None else [dim]), path
            if dim is None:
                np.testing.assert_array_equal(shard, leaf, err_msg=path)
                continue
            assert shard.shape == leaf.shape[:-1] + (leaf.shape[-1] // m,), path
            index = rank % m
            np.testing.assert_array_equal(
                shard, np.split(leaf, m, axis=-1)[index], err_msg=path)
        net = path.split("/", 1)[0]
        if "/sn/" in path:   # u and v take no Adam step
            continue
        moments = [r["moments"][path] for r in ranks[:m]]
        for i, which in enumerate(("mu", "nu")):
            got = np.concatenate([mo[i] for mo in moments], axis=-1) if dim is not None \
                else moments[0][i]
            assert got.shape == leaf.shape
            label = tckpt.ADAM_PATHS[tckpt.LABELS[net]]
            want = jax_opt[f"{label}/{which}/{path}"]
            np.testing.assert_allclose(got, want, rtol=PARAM_RTOL,
                                       atol=PARAM_ATOL * max(1.0, np.abs(want).max()),
                                       err_msg=f"{which} {path}")
        assert all(mo[2] == 1.0 for mo in moments)


def test_data_parallel_step_matches_unsharded(runs):
    um, uflat = runs["unsharded"]
    r = runs["port"][(2, 1)][0]["step"]
    for k in um:
        np.testing.assert_allclose(r["metrics"][k], um[k], rtol=LOSS_RTOL, err_msg=k)
    for path, leaf in uflat.items():
        np.testing.assert_allclose(r["full"][path], leaf, rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=path)
    assert [x["step"]["rows"] for x in runs["port"][(2, 1)]] == [(4, 0), (4, 4)]


def test_model_parallel_step_is_bit_equal_to_unsharded(runs):
    um, uflat = runs["unsharded"]
    for r in (x["step"] for x in runs["port"][(1, 2)]):
        assert r["metrics"] == um
        for path, leaf in uflat.items():
            np.testing.assert_array_equal(r["full"][path], leaf, err_msg=path)
        assert r["rows"] == (8, 0)


def test_host_datasource_under_model_split_trains_as_unsharded(runs):
    """A host datasource's rows differ by process (``RankSource``): on
    (1, 2) the first process of the 'model' group collects them and sends
    them to its peer, which never collects, and ``train`` on the mesh
    equals ``train`` without one on the first process's source, bit for
    bit."""
    with _one_thread():
        want = W.host_train(_jax_params(HIDDEN), HOST_CFG)
    ranks = [x["host"] for x in runs["port"][(1, 2)]]
    assert [r["calls"] for r in ranks] == [want["calls"], 0]
    assert want["calls"] == 2
    for r in ranks:
        assert r["metrics"] == want["metrics"]
        for path, leaf in want["full"].items():
            np.testing.assert_array_equal(r["full"][path], leaf, err_msg=path)


def check_spatial(runs, shape):
    """Each process's rows of the H-split transition: JAX's
    ``transition(train=False)``'s, bit for bit."""
    d, m = shape
    ref = runs["spatial_ref"]
    rows_b, rows_h = SPATIAL_B // d, SPATIAL_HW // m
    for r in (x["spatial"] for x in runs["port"][shape]):
        want = ref[r["data"] * rows_b:(r["data"] + 1) * rows_b,
                   r["model"] * rows_h:(r["model"] + 1) * rows_h]
        assert r["out"].shape == want.shape
        np.testing.assert_array_equal(r["out"], want)
        assert set(np.unique(r["out"])) <= {0.0, 1.0}


@pytest.mark.parametrize("shape", HERE, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax(runs, shape):
    check_matches_jax(runs, shape)


@pytest.mark.parametrize("shape", HERE, ids=lambda s: f"{s[0]}x{s[1]}")
def test_shards_have_leaf_spec_shapes(runs, shape):
    check_shards(runs, shape)


def test_spatial_transition_matches_jax(runs):
    check_spatial(runs, (1, 2))
