"""The port's command line (``python -m scmgan_tpu_torch``,
scmgan_tpu_torch.cli.main) against scmgan_tpu.cli.main on the CPU.

The parser and the Config it builds equal JAX's; a ``--platform cpu`` run
resumes from a checkpoint the JAX package wrote and writes one the JAX
package loads; ``--evaluate`` runs the evaluation, the causal graph and the
Higgins metric; the student gate, the ``--mesh`` refusal and the default
device.  The runs use gridworld at hidden 16 (``config_from_args`` is
wrapped to narrow the Config, as the command line has no width flag) and a
recorder in place of ``play``: the real episodes run on the card.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from scmgan_tpu.cli import main as jcli
from scmgan_tpu.config import Config as JaxConfig
from scmgan_tpu.envs import get_env as jget_env
from scmgan_tpu.train import checkpoint as jckpt
from scmgan_tpu.train import trainer as jtr
from scmgan_tpu_torch.agent import play as tplay
from scmgan_tpu_torch.cli import main as cli
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.envs import get_env as tget_env
from scmgan_tpu_torch.train import checkpoint as tckpt
from scmgan_tpu_torch.train import trainer as ttr

REPO = os.path.join(os.path.dirname(__file__), "..")
STUDENT = os.path.join(REPO, "pretrained_models", "minipacman_student_h48")
HIDDEN = 16
SMALL = ["--platform", "cpu", "--batch-size", "2", "--eval-batch-size", "2",
         "--eval-timesteps", "5"]


@pytest.fixture
def narrow(monkeypatch):
    """The command line's Config at hidden 16."""
    build = cli.config_from_args
    monkeypatch.setattr(cli, "config_from_args",
                        lambda args: build(args).replace(hidden_dim=HIDDEN))


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.required,
                     a.nargs, a.const, type(a).__name__) for a in parser._actions}


def test_parser_matches_jax():
    ours, theirs = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert ours == theirs
    assert len(ours) == 47   # help + 46 options


@pytest.mark.parametrize("argv", [
    ["--env", "pong"],
    ["--env", "minipacman", "--load-from", "x", "--evaluate", "--evaluations", "3",
     "--title", "t", "--batch-size", "7", "--train-iters", "9", "--start-iter", "4",
     "--truncate-bptt", "--latent-overshooting", "--latent-td", "--td-lambda", "0.5",
     "--td-steps", "2", "--horizon-min", "4", "--horizon-max", "6",
     "--learning-rate", "0.01", "--finetune-reward", "--reward-coef", "0.2",
     "--activation-l1-coef", "0.3", "--transition-l1-coef", "0.4",
     "--deterministic-transition", "--enable-action-control-loss",
     "--enable-disentanglement-loss", "--counterfactual-horizon", "3", "--seed", "5",
     "--out-dir", "o", "--compute-dtype", "float32", "--scan-unroll", "2",
     "--eval-batch-size", "11", "--eval-timesteps", "12", "--iters-per-video", "13",
     "--mpc-samples", "4", "--mpc-lookahead", "1", "--mpc-depth", "5",
     "--mpc-policy", "greedy", "--mpc-tradeoff", "0.1", "--mpc-stall-patience", "0"],
])
def test_config_from_args_matches_jax(argv):
    ours = cli.config_from_args(cli.build_parser().parse_args(argv))
    theirs = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    shared = set(vars(ours)) & set(vars(theirs))
    assert len(shared) == len(vars(theirs))
    for name in shared:
        assert getattr(ours, name) == getattr(theirs, name), name


def test_mesh_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 1.9"):
        cli.main(["--env", "gridworld", "--platform", "cpu", "--mesh", "2x1"])


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cli.platform_device(None) == torch.device("cuda")
    assert cli.platform_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        cli.platform_device("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--env", "gridworld"])
    with pytest.raises(ValueError, match="Unknown environment"):
        cli.main(["--env", "nosuchenv", "--platform", "cpu"])


def test_module_help_runs():
    out = subprocess.run([sys.executable, "-m", "scmgan_tpu_torch", "--help"],
                         capture_output=True, text=True, timeout=120, cwd=REPO,
                         check=True).stdout
    for flag in ("--env", "--platform", "--mpc-int8", "--student", "--higgins"):
        assert flag in out


def test_resumes_jax_checkpoint_and_writes_one_jax_loads(tmp_path, narrow, monkeypatch):
    """JAX writes a state with count 5, step 6 and nonzero moments; the port
    resumes it bit for bit, trains iterations 6 and 7, and checkpoints
    before iteration 8: count 7, step 8, which JAX loads."""
    jcfg = JaxConfig(env="gridworld", hidden_dim=HIDDEN)
    js = jtr.init_train_state(jcfg, jget_env("gridworld"), jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    flat, treedef = jax.tree_util.tree_flatten_with_path(js.opt_state)
    leaves = [np.asarray(5, np.int32) if x.ndim == 0 else
              np.zeros_like(x) if "/sn/" in jckpt._path_str(p) else
              np.abs(rng.standard_normal(x.shape)).astype(np.float32) * 1e-3
              for p, x in flat]
    js = js._replace(opt_state=jax.tree_util.tree_unflatten(treedef, leaves),
                     step=np.asarray(6, np.int32))
    src, out = tmp_path / "jax", tmp_path / "port"
    jckpt.save_train_state(str(src), js)

    loaded = {}
    load = tckpt.load_train_state

    def recording_load(ckpt_dir, template):
        state = load(ckpt_dir, template)
        loaded["step"] = state.step
        loaded["moments"] = {
            f"{name}/{path}": opt.state[leaf]["exp_avg"].clone()
            for name, opt in state.optimizers.items()
            for path, leaf in tckpt.flatten_tree(getattr(state.params, name))
            if leaf in opt.state}
        return state

    monkeypatch.setattr(tckpt, "load_train_state", recording_load)
    res = cli.main(["--env", "gridworld", *SMALL, "--load-from", str(src),
                    "--start-iter", "6", "--train-iters", "8", "--iters-per-video", "4",
                    "--no-videos", "--out-dir", str(out)])
    assert loaded["step"] == 6
    with np.load(src / "opt_state.npz") as d:
        for key, mu in loaded["moments"].items():
            label = tckpt.ADAM_PATHS[tckpt.LABELS[key.split("/")[0]]]
            np.testing.assert_array_equal(mu.numpy(), d[f"{label}/mu/{key}"])
    assert len(loaded["moments"]) == sum(
        len(ttr.trainable_leaves(getattr(res["state"].params, n)))
        for n in tckpt.MODEL_FILES)
    assert res["state"].step == 9
    assert (out / "mse_pixel_iter_000008.json").exists()

    back = jckpt.load_train_state(str(out), jtr.init_train_state(
        jcfg, jget_env("gridworld"), jax.random.PRNGKey(0)))
    assert int(back.step) == 8
    assert int(back.opt_state.inner_states["clipped"].inner_state[1][0].count) == 7
    assert int(back.opt_state.inner_states["plain"].inner_state[0].count) == 7


def test_evaluate_causal_graph_and_higgins(tmp_path, narrow):
    spec = tget_env("gridworld")
    state = ttr.init_train_state(Config(env="gridworld", hidden_dim=HIDDEN), spec,
                                 torch.Generator().manual_seed(0))
    tckpt.save_model(str(tmp_path / "bundle"), state.params)
    out = tmp_path / "eval"
    res = cli.main(["--env", "gridworld", *SMALL, "--evaluate", "--evaluations", "0",
                    "--load-from", str(tmp_path / "bundle"), "--causal-graph",
                    "--causal-runs", "1", "--higgins", "--higgins-iters", "20",
                    "--out-dir", str(out)])
    assert res["scores"] == []
    assert len(res["evaluate"][0]) == 3 and np.isfinite(res["evaluate"]).all()
    assert res["causal_graph"].shape == (16, 16)
    assert 0.0 <= res["higgins"]["conv"] <= 1.0 and 0.0 <= res["higgins"]["spatial"] <= 1.0
    with open(out / "causal_matrix_iter_000001.json") as f:
        record = json.load(f)
    assert sorted(record) == ["max", "mean_deviation", "runs"] and record["runs"] == 1
    np.testing.assert_array_equal(np.asarray(record["max"]), res["causal_graph"])
    written = sorted(os.listdir(out))
    for prefix in ("mse_pixel_iter_000001.json", "simulation_ftr_iter_000001",
                   "prediction_01_iter_000001", "reward_prediction_03_iter_000001",
                   "causal_matrix_iter_000001.png"):
        assert any(w.startswith(prefix) for w in written), (prefix, written)


def test_play_flags_reach_play(tmp_path, narrow, monkeypatch):
    calls = []

    def recorder(params, datasource, **kw):
        calls.append(kw)
        return 1.0, 3

    monkeypatch.setattr(tplay, "play", recorder)
    res = cli.main(["--env", "gridworld", *SMALL, "--evaluate", "--evaluations", "2",
                    "--mpc-int8", "--mpc-samples", "3", "--mpc-lookahead", "1",
                    "--mpc-depth", "5", "--mpc-policy", "greedy", "--mpc-tradeoff", "0.5",
                    "--mpc-stall-patience", "4", "--no-videos", "--out-dir", str(tmp_path)])
    assert res["scores"] == [(1.0, 3), (1.0, 3)]
    assert calls == [dict(max_steps=300, rollout_depth=5, lookahead=1,
                          negative_positive_tradeoff=0.5, out_dir=str(tmp_path),
                          use_int8=True, rollout_samples=3, rollout_policy="greedy",
                          stall_patience=4, write_video=False)] * 2


def _student_copy(tmp_path, **record):
    dst = tmp_path / "student"
    shutil.copytree(STUDENT, dst)
    with open(dst / "fidelity.json") as f:
        fid = json.load(f)
    fid.update(record)
    with open(dst / "fidelity.json", "w") as f:
        json.dump(fid, f)
    return str(dst)


def test_student_gate(tmp_path):
    argv = ["--env", "minipacman", *SMALL, "--evaluate", "--evaluations", "0",
            "--no-videos", "--out-dir", str(tmp_path / "out"), "--student"]
    with pytest.raises(SystemExit, match="fidelity gate FAILED"):
        cli.main(argv + [_student_copy(tmp_path / "a", within_1pct=False)])
    with pytest.raises(ValueError, match="shape"):
        cli.main(argv + [_student_copy(tmp_path / "b", hidden=64)])
    with pytest.raises(SystemExit, match="does not train"):
        cli.main([a for a in argv if a != "--evaluate"] + [STUDENT])
    res = cli.main(argv + [STUDENT])
    served = res["state"].params.transition
    assert served["conv2"]["w"].shape[-1] == 48
    with np.load(os.path.join(STUDENT, "model-transition.npz")) as d:
        np.testing.assert_array_equal(served["conv2"]["w"].numpy(), d["conv2/w"])
