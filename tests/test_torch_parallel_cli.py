"""``python -m scmgan_tpu_torch --mesh`` on the CPU: processes that a
launcher would start (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``; the group
meets in a ``FileStore`` named by ``SCMGAN_INIT_METHOD``, as several test
workers run at once), gridworld at the default width, B = 4, in f32 as the
JAX package's sharding tests run (in bf16 the convs over 2 and over 4 rows
round differently on the CPU, about 1e-3 of the reward loss after ten
Adam steps).

  * ``--mesh 2x1`` in two processes logs the one-process run's losses
    (rtol 1e-4; the console prints six decimals, so the printed values
    also differ by up to 1e-6);
  * its first process alone prints the log and the checkpoint message, and
    the checkpoint (before iteration 10) loads in the unsharded port and in
    the JAX package, with the same parameters;
  * ``--mesh 1x2`` in two processes, resumed from that checkpoint, logs
    and checkpoints what the same resume in one process without a mesh
    does, bit for bit.

Every process runs one CPU thread, so that a conv's weight gradient sums
in one order in all of them.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from scmgan_tpu.config import Config as JaxConfig
from scmgan_tpu.train import checkpoint as jckpt
from scmgan_tpu.train import trainer as jtr
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.envs import get_env
from scmgan_tpu_torch.train import checkpoint as tckpt
from scmgan_tpu_torch.train import trainer as ttr

REPO = os.path.join(os.path.dirname(__file__), "..")
ARGS = ["--env", "gridworld", "--platform", "cpu", "--batch-size", "4",
        "--horizon-min", "3", "--horizon-max", "4", "--eval-batch-size", "2",
        "--eval-timesteps", "5", "--no-videos", "--compute-dtype", "float32"]
LOSS_RTOL, PRINT_ATOL = 1e-4, 1e-6
SUMMARY = re.compile(r"^\s+(\w+)\s+(-?\d+\.\d+)\s", re.M)


def _start(argv, store=None, rank=None, world=None):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SCMGAN_INIT_METHOD"):
        env.pop(var, None)
    if store is not None:
        env.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                   SCMGAN_INIT_METHOD=f"file://{store}")
    return subprocess.Popen([sys.executable, "-m", "scmgan_tpu_torch", *ARGS, *argv],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs):
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    return outs


def _logged(out):
    return [(k, float(v)) for k, v in SUMMARY.findall(out)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cli")
    first = ["--train-iters", "10", "--iters-per-video", "5"]
    procs = [_start([*first, "--mesh", "2x1", "--out-dir", str(d / "mesh")],
                    d / "store_a", r, 2) for r in range(2)]
    procs.append(_start([*first, "--out-dir", str(d / "plain")]))
    mesh0, mesh1, plain = _finish(procs)
    resume = ["--load-from", str(d / "mesh"), "--start-iter", "10", "--train-iters", "12",
              "--iters-per-video", "6"]
    procs = [_start([*resume, "--mesh", "1x2", "--out-dir", str(d / "resume_mesh")],
                    d / "store_b", r, 2) for r in range(2)]
    procs.append(_start([*resume, "--out-dir", str(d / "resume_plain")]))
    resumed0, resumed1, resumed_plain = _finish(procs)
    return {"dir": d, "mesh": (mesh0, mesh1), "plain": plain,
            "resumed": (resumed0, resumed1), "resumed_plain": resumed_plain}


def test_mesh_2x1_logs_the_one_process_losses(runs):
    mesh0, mesh1 = runs["mesh"]
    got, want = _logged(mesh0), _logged(runs["plain"])
    assert [k for k, _ in got] == [k for k, _ in want] and "loss" in dict(want)
    for (k, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=LOSS_RTOL, atol=PRINT_ATOL, err_msg=k)
    # the log and the checkpoint message are the first process's alone
    assert _logged(mesh1) == []
    assert mesh0.count("Saving networks") == 2 and "Saving networks" not in mesh1


def test_mesh_checkpoint_loads_unsharded_and_in_jax(runs):
    ckpt = str(runs["dir"] / "mesh")
    assert sorted(f for f in os.listdir(ckpt) if f.endswith(".npz")) == sorted(
        [*tckpt.MODEL_FILES.values(), tckpt.OPT_FILE, tckpt.STEP_FILE])
    spec = get_env("gridworld")
    ours = tckpt.load_train_state(ckpt, ttr.init_train_state(
        Config(env="gridworld"), spec, torch.Generator().manual_seed(1)))
    assert ours.step == 10 and ours.shardings is None
    assert {float(st["step"]) for opt in ours.optimizers.values()
            for st in opt.state.values()} == {9.0}
    theirs = jckpt.load_train_state(ckpt, jtr.init_train_state(
        JaxConfig(env="gridworld"), spec, jax.random.PRNGKey(1)))
    assert int(theirs.step) == 10
    mine = {f"{n}/{k}": v.detach().numpy() for n in ours.params._fields
            for k, v in tckpt.flatten_tree(getattr(ours.params, n))}
    for k, v in jax.tree_util.tree_flatten_with_path(theirs.params._asdict())[0]:
        np.testing.assert_array_equal(np.asarray(v), mine[jckpt._path_str(k)])


def test_mesh_1x2_resume_continues_as_one_process(runs):
    resumed0, _ = runs["resumed"]
    assert _logged(resumed0) == _logged(runs["resumed_plain"]) != []
    a, b = runs["dir"] / "resume_mesh", runs["dir"] / "resume_plain"
    for name in [*tckpt.MODEL_FILES.values(), tckpt.OPT_FILE, tckpt.STEP_FILE]:
        with np.load(a / name) as x, np.load(b / name) as y:
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name}:{k}")
    with np.load(a / tckpt.STEP_FILE) as s:
        assert int(s["step"]) == 12
