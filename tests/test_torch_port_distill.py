"""The port's distillation (scmgan_tpu_torch.train.distill and
scmgan_tpu_torch.cli.distill_student) against scmgan_tpu's on the CPU:
``fake_quant_transition`` forward and gradients, two distillation steps
(plain, then QAT on JAX's ``activation_scales``), two ground-truth
fine-tune steps, the cosine schedule, and the command line at a tiny size.

Every step draws its data from JAX's keys (the env rollout, the DAgger mix
mask), replayed into the port through a ``DistillNoise`` subclass.  The
teacher is a random hidden-16 world model at gridworld's 16 x 16, the
student a hidden-8 transition, both drawn by the port and handed to both
sides as numpy; one JAX compile per step kind.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from scmgan_tpu.envs import get_env as jax_get_env
from scmgan_tpu.envs.base import rollout as jax_rollout
from scmgan_tpu.models import world_model as jwm
from scmgan_tpu.train import checkpoint as jckpt
from scmgan_tpu.train import distill as jd
from scmgan_tpu.train import trainer as jtr
from scmgan_tpu.utils import compile_cache as jcc
from scmgan_tpu_torch.cli import distill_student as cli
from scmgan_tpu_torch.envs import get_env
from scmgan_tpu_torch.models import quantized as tq
from scmgan_tpu_torch.models import world_model as twm
from scmgan_tpu_torch.train import checkpoint as tckpt
from scmgan_tpu_torch.train import distill as td

REPO = os.path.join(os.path.dirname(__file__), "..")
ENV = "gridworld"
LATENT = 16
TEACHER_HIDDEN, STUDENT_HIDDEN = 16, 8
BATCH, ROLLOUT, GT_HORIZON = 2, 3, 12
LR, GT_LR, ITERS = 1e-3, 1e-4, 4
# The forward of the fake-quant student: both sides compute the same f32
# ops, summing the convs in other orders (about 1e-6 relative); a
# requantized activation that lands on a rounding tie on one side moves one
# grid step on the other, so the sigmoid may differ more there, and such
# flips are counted and bounded.
FQ_ATOL = 1e-5
MAX_TIE_FLIP_FRACTION = 1e-3
# Losses: f32 sums in other orders.
LOSS_RTOL = 1e-5
# After Adam a parameter moves by about lr a step whatever the gradient's
# size, so two steps agree to the rounding of that ratio (1e-3 of lr) plus
# the f32 ulp of the parameter; where the gradient is at the level of the
# two frameworks' difference (below 1e-4 of the leaf's largest entry) its
# sign can differ, and the move by up to 2 lr a step (the tolerances of
# test_torch_port_train_step.py).
STEP_ATOL_OF_LR = 1e-3
NOISY_GRAD_OF_MAX = 1e-4
# The GT fine-tune's gradient sums through 12 hard-binarized steps, with an
# absolute noise floor of about 3e-7 of a leaf's largest entry (measured
# on its first step): at 1e-4 of the largest that is 3e-3 relative, which
# moves Adam's second step by up to about 3e-3 lr.  Its noise level is
# therefore 1e-3 of the largest (3e-4 relative).
NOISY_GRAD_OF_MAX_GT = 1e-3
SN_ATOL = 1e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _torch_leaves(tree):
    return _leaves(jax.tree.map(lambda t: t.detach().numpy(), tree))


def _np_world_model(seed, spec, hidden):
    """A random world model as JAX's numpy tree, drawn by the port (the same
    tree, shapes and dtypes; JAX's initializer is not under test here)."""
    wm = twm.init_world_model(torch.Generator().manual_seed(seed), LATENT, spec.num_actions,
                              spec.num_rewards, spec.channels, spec.channels, hidden=hidden,
                              img_size=spec.height)
    return jwm.WorldModel(**tckpt.params_to_numpy(wm))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port on one intra-op thread in this module: its thousands of
    small ops (the rollouts of each calibration and gate) slow by two
    orders of magnitude when each wakes a thread per core on a loaded host
    (measured: the command-line test 5 s alone, 328 s beside five test
    workers, 27 s so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    spec = jax_get_env(ENV)
    teacher = _np_world_model(1, spec, TEACHER_HIDDEN)
    student = _np_world_model(2, spec, STUDENT_HIDDEN).transition
    return spec, teacher, student


class Replay(td.DistillNoise):
    """JAX's draws for one step: the rollout's arrays and the mix mask."""

    def __init__(self, batch, use=None):
        super().__init__(torch.Generator())
        self.batch = tuple(torch.from_numpy(np.array(x)) for x in batch)
        self.use = None if use is None else torch.from_numpy(np.array(use))

    def rollout(self, spec, batch_size, timesteps):
        assert self.batch[0].shape[:2] == (batch_size, timesteps)
        return self.batch

    def mix(self, p_on_policy, steps, batch_size):
        assert self.use.shape == (steps, batch_size)
        return self.use


# JAX's env rollout, one compile a shape (the steps draw the same inside
# their own jit)
_jax_rollout = jax.jit(jax_rollout, static_argnums=(0, 2, 3, 4))


def _distill_draws(spec, key, p):
    k_env, k_mix = jax.random.split(key)
    batch = _jax_rollout(spec, k_env, BATCH, ROLLOUT + 2, "random")
    return batch, jax.random.bernoulli(k_mix, p, (ROLLOUT, BATCH))


def _tx(lr, n):
    return optax.chain(optax.clip(0.1), optax.adam(
        optax.cosine_decay_schedule(lr, n, alpha=0.05)))


def _act_scale(student, spec, seed):
    """Activation scales of ``student`` on random binary latents and 5 random
    actions (the port's ``activation_scales``; both sides get these)."""
    rng = np.random.default_rng(seed)
    z = (rng.random((4, 16, 16, LATENT)) > 0.5).astype(np.float32)
    a = np.eye(spec.num_actions, dtype=np.float32)[rng.integers(0, spec.num_actions, (4, 5))]
    act = tq.activation_scales(_torch_tree(student), torch.from_numpy(z), torch.from_numpy(a))
    return {k: v.numpy() for k, v in act.items()}


def _assert_params_close(port_student, jax_student, lr, noisy, steps):
    got = _torch_leaves(port_student)
    want = _leaves(_np_tree(jax_student))
    assert list(got) == list(want)
    for path, leaf in want.items():
        limit = STEP_ATOL_OF_LR * lr + 1e-7 * np.abs(leaf)
        if path in noisy:
            limit = np.where(noisy[path], 2 * lr * steps, limit)
        err = np.abs(got[path] - leaf)
        assert np.all(err <= (SN_ATOL if "'sn'" in path else limit)), (path, float(err.max()))


def _resync(port_student, jax_student):
    """The port's parameters set to JAX's after a step, in place (the
    optimizer keeps its state): each step is then compared from the same
    parameters.  A step moves a parameter whose gradient is at the two
    frameworks' noise level by up to 2 lr the other way, and a rollout of
    hard-binarized steps carries that into the next step's gradients at
    about 1% of lr (measured on the GT step)."""
    want = _np_tree(jax_student)
    with torch.no_grad():
        for name, node in port_student.items():
            for k in ("w", "b"):
                node[k].copy_(torch.from_numpy(np.array(want[name][k])))
            if "sn" in node:
                node["sn"] = _torch_tree(want[name]["sn"])


def _record_noisy(noisy, student, of_max=NOISY_GRAD_OF_MAX):
    for name, node in student.items():
        for k in ("w", "b"):
            g = node[k].grad
            if g is None:
                continue
            g = g.abs().numpy()
            key = f"['{name}']['{k}']"
            noisy[key] = noisy.get(key, False) | (g < of_max * g.max())


def test_fake_quant_transition_matches_jax(setup):
    """Forward and gradients of the fake-quant student; rounding-tie flips
    of the requantized activations counted."""
    spec, teacher, student = setup
    act_scale = _act_scale(student, spec, 5)
    rng = np.random.default_rng(0)
    z = (rng.random((3, 16, 16, LATENT)) > 0.5).astype(np.float32)
    a = np.eye(spec.num_actions, dtype=np.float32)[[0, 2, 3]]
    w = rng.random((3, 16, 16, LATENT)).astype(np.float32)

    def jloss(sp):
        p = jd.fake_quant_transition(sp, act_scale, jnp.asarray(z), jnp.asarray(a))
        return jnp.sum(p * w), p

    (_, pj), gj = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, student))
    ts = _torch_tree(student)
    for node in ts.values():
        node["w"].requires_grad_(True)
        node["b"].requires_grad_(True)
    pt = td.fake_quant_transition(ts, _torch_tree(act_scale), torch.from_numpy(z),
                                  torch.from_numpy(a))
    (pt * torch.from_numpy(w)).sum().backward()
    diff = np.abs(pt.detach().numpy() - np.asarray(pj))
    flips = diff > FQ_ATOL
    print(f"fake-quant forward: max |diff| {diff.max():.3g}, {int(flips.sum())} of "
          f"{flips.size} outputs past {FQ_ATOL} (tie flips)")
    assert flips.mean() <= MAX_TIE_FLIP_FRACTION
    gj = _leaves(_np_tree(gj))
    for name, node in ts.items():
        for k in ("w", "b"):
            want = gj[f"['{name}']['{k}']"]
            got = node[k].grad.numpy()
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                       err_msg=f"{name}/{k}")


def test_distill_and_qat_steps_match_jax(setup):
    """Two plain distillation steps, then two QAT steps on the same
    activation scales, on one shared optimizer state (the JAX script's),
    with the DAgger mix at p = 0.5: losses, bit accuracies and the updated
    students, each step from JAX's parameters (``_resync``)."""
    spec, teacher, student = setup
    tx, jteacher = _tx(LR, ITERS), jax.tree.map(jnp.asarray, teacher)
    steps = {"plain": jd.make_distill_step(spec, jteacher, tx, BATCH, ROLLOUT),
             "qat": jd.make_distill_step(spec, jteacher, tx, BATCH, ROLLOUT, qat=True)}
    js = jax.tree.map(jnp.asarray, student)
    opt_state = tx.init(js)
    tteacher = tckpt.params_from_numpy(teacher, device="cpu")
    ts = _torch_tree(student)
    opt = td.DistillOptimizer(ts, LR, ITERS)
    tspec = get_env(ENV)
    port = {"plain": td.make_distill_step(tspec, tteacher, opt, BATCH, ROLLOUT),
            "qat": td.make_distill_step(tspec, tteacher, opt, BATCH, ROLLOUT, qat=True)}
    act_scale = _act_scale(student, spec, 7)
    noisy = {}
    for i, kind in enumerate(("plain", "plain", "qat", "qat")):
        key = jax.random.PRNGKey(100 + i)
        batch, use = _distill_draws(spec, key, 0.5)
        extra = (act_scale,) if kind == "qat" else ()
        js, opt_state, jloss, jbits = steps[kind](js, opt_state, key, 0.5, *extra)
        t_extra = (_torch_tree(act_scale),) if kind == "qat" else ()
        ts, tloss, tbits = port[kind](ts, Replay(batch, use), 0.5, *t_extra)
        print(f"{kind} step {i}: bce JAX {float(jloss):.7f} port {float(tloss):.7f}, "
              f"bits JAX {float(jbits):.6f} port {float(tbits):.6f}")
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
        # the same agreeing bits (their f32 means may round 1 ulp apart)
        n_bits = ROLLOUT * BATCH * 16 * 16 * LATENT
        assert round(float(tbits) * n_bits) == round(float(jbits) * n_bits)
        _record_noisy(noisy, ts)
        _assert_params_close(ts, js, LR, noisy, i + 1)
        _resync(ts, js)
    assert opt.adam.state[ts["conv1"]["w"]]["step"] == 4


def test_gt_finetune_steps_match_jax(setup):
    """Two QAT ground-truth fine-tune steps: the gate and mean MSE, and the
    updated students (a fresh optimizer with its own schedule), each step
    from JAX's parameters."""
    spec, teacher, student = setup
    tx = _tx(GT_LR, ITERS)
    jstep = jd.make_gt_finetune_step(spec, jax.tree.map(jnp.asarray, teacher), tx, BATCH,
                                     GT_HORIZON)
    js = jax.tree.map(jnp.asarray, student)
    opt_state = tx.init(js)
    tteacher = tckpt.params_from_numpy(teacher, device="cpu")
    ts = _torch_tree(student)
    step = td.make_gt_finetune_step(get_env(ENV), tteacher,
                                    td.DistillOptimizer(ts, GT_LR, ITERS), BATCH, GT_HORIZON)
    act_scale = _act_scale(student, spec, 9)
    noisy = {}
    for i in range(2):
        key = jax.random.PRNGKey(200 + i)
        batch = _jax_rollout(spec, key, BATCH, GT_HORIZON + 3, "random")
        js, opt_state, jgate, jmean = jstep(js, opt_state, key, act_scale)
        ts, tgate, tmean = step(ts, Replay(batch), _torch_tree(act_scale))
        print(f"gt step {i}: gate JAX {float(jgate):.7f} port {float(tgate):.7f}, "
              f"mean JAX {float(jmean):.7f} port {float(tmean):.7f}")
        np.testing.assert_allclose(float(tgate), float(jgate), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tmean), float(jmean), rtol=LOSS_RTOL)
        _record_noisy(noisy, ts, NOISY_GRAD_OF_MAX_GT)
        _assert_params_close(ts, js, GT_LR, noisy, i + 1)
        _resync(ts, js)


def test_cosine_schedule_matches_optax():
    """The lr of update k: optax's cosine_decay_schedule at k = 0, N/2, N
    (and past N), with the LambdaLR stepped after each Adam step."""
    n = 8
    sched = optax.cosine_decay_schedule(LR, n, alpha=0.05)
    leaf = torch.zeros(3)
    opt = td.DistillOptimizer({"conv": {"w": leaf}}, LR, n)
    used = []
    for _ in range(n + 2):
        used.append(opt.adam.param_groups[0]["lr"])
        leaf.grad = torch.ones(3)
        opt.step()
    for k in (0, n // 2, n, n + 1):
        np.testing.assert_allclose(used[k], float(sched(k)), rtol=1e-6, err_msg=str(k))
        np.testing.assert_allclose(LR * td.cosine_decay(k, n), float(sched(k)), rtol=1e-6)
    assert used[0] == LR
    # the value clip binds before Adam; a constant lr without decay steps
    leaf.grad = torch.full((3,), 5.0)
    flat = td.DistillOptimizer({"conv": {"w": torch.zeros(3)}}, LR)
    assert flat.schedule is None and flat.adam.param_groups[0]["lr"] == LR


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _run_cli(argv, capsys):
    out = cli.main(argv)
    printed = capsys.readouterr().out
    run_lines = [line for line in printed.splitlines() if line.startswith('{"run":')]
    assert len(run_lines) == 1
    return out, json.loads(run_lines[0])["run"]


@pytest.fixture(scope="module")
def teacher_dir(setup, tmp_path_factory):
    _, teacher, _ = setup
    path = tmp_path_factory.mktemp("teacher")
    tckpt.save_model(str(path), tckpt.params_from_numpy(teacher, device="cpu"))
    return str(path)


@pytest.fixture(scope="module")
def jax_records(setup, tmp_path_factory):
    """The JAX script's fidelity.json for 1 and 2 eval seeds
    (``--fidelity-only`` on a JAX-written hidden-8 student).  The JAX script
    builds its teacher's template at the Config's hidden 128, so its teacher
    is the shipped gridworld_cf; the template (only its shapes are read, and
    gridworld_cf has no optimizer state) is the port's numpy init, and the
    tests' compile cache stays as conftest set it."""
    spec_path = os.path.join(REPO, "scripts", "distill_student.py")
    mod_spec = importlib.util.spec_from_file_location("jax_distill_student", spec_path)
    script = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(script)
    spec, _, student = setup

    def template(cfg, env_spec, key):
        return jtr.TrainState(_np_world_model(0, spec, cfg.hidden_dim), None, 0)

    records = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcc, "setup_compile_cache", lambda *a, **k: None)
        mp.setattr(jtr, "init_train_state", template)
        for seeds in (1, 2):
            out = tmp_path_factory.mktemp(f"jax_fid{seeds}")
            jckpt.save_pytree(str(out / "model-transition.npz"), student)
            script.main(["--env", ENV, "--teacher",
                         os.path.join(REPO, "pretrained_models", "gridworld_cf"),
                         "--hidden", str(STUDENT_HIDDEN), "--fidelity-only",
                         "--eval-batch-size", "2", "--eval-timesteps", "14",
                         "--eval-seeds", str(seeds), "--out", str(out)])
            with open(out / "fidelity.json") as f:
                records[seeds] = json.load(f)
    return records


def _key_tree(record):
    """A record's keys, with the keys (horizons) of its nested curves."""
    return {k: (sorted(v) if isinstance(v, dict) else None) for k, v in record.items()}


def test_cli_makes_a_student_that_jax_loads(setup, teacher_dir, jax_records, tmp_path,
                                            capsys):
    """Distillation with the QAT tail, the GT fine-tune and a 2-seed gate at
    a tiny size: the student loads in the JAX package, the teacher's hash
    and decoder are JAX's, fidelity.json has the JAX script's keys."""
    spec, teacher, _ = setup
    out = tmp_path / "student"
    res, run = _run_cli(
        ["--env", ENV, "--teacher", teacher_dir, "--hidden", str(STUDENT_HIDDEN),
         "--iters", "4", "--batch-size", str(BATCH), "--rollout", str(ROLLOUT),
         "--qat-from", "0.5", "--qat-recal", "1", "--gt-iters", "2",
         "--gt-horizon", str(GT_HORIZON), "--gt-batch-size", str(BATCH),
         "--eval-batch-size", "2", "--eval-timesteps", "14", "--eval-seeds", "2",
         "--platform", "cpu", "--out", str(out)], capsys)
    assert len(run["bce"]) == 4 and len(run["gt_gate_mse"]) == 2 and run["qat_start"] == 2
    assert np.isfinite(run["bce"] + run["bit_acc"] + run["gt_gate_mse"]
                       + run["gt_mean_mse"]).all()
    assert all(n == 0 for stage in run["launches"].values() for n in stage.values())
    template = jwm.init_transition(jax.random.PRNGKey(0), LATENT, spec.num_actions,
                                   hidden=STUDENT_HIDDEN)
    loaded = _leaves(_np_tree(jckpt.load_pytree(str(out / "model-transition.npz"),
                                                template)))
    mine = _torch_leaves(res["student"])
    assert list(loaded) == list(mine)
    for path, leaf in loaded.items():
        np.testing.assert_array_equal(leaf, mine[path], err_msg=path)
    with np.load(out / "model-decoder.npz") as dec:
        for path, leaf in tckpt.flatten_tree(_torch_tree(teacher.decoder)):
            np.testing.assert_array_equal(dec[path], leaf.numpy())
    with open(out / "fidelity.json") as f:
        fid = json.load(f)
    assert fid["teacher_hash"] == jckpt.bundle_hash(teacher_dir)
    assert _key_tree(fid) == _key_tree(jax_records[2])
    assert fid["eval_seeds"] == 2 and len(fid["mse10_delta_per_seed"]) == 2


def test_cli_init_from_and_fidelity_only(setup, teacher_dir, jax_records, tmp_path,
                                         capsys):
    """A JAX-written student warm-starts the port (one step at lr 0 leaves
    its weights as written); ``--fidelity-only`` re-reads <out>, writes
    fidelity.json there with the JAX script's one-seed keys."""
    _, _, student = setup
    src = tmp_path / "jax_student"
    src.mkdir()
    jckpt.save_pytree(str(src / "model-transition.npz"), student)
    out = tmp_path / "out"
    common = ["--env", ENV, "--teacher", teacher_dir, "--hidden", str(STUDENT_HIDDEN),
              "--eval-batch-size", "2", "--eval-timesteps", "14", "--platform", "cpu",
              "--out", str(out)]
    res, _ = _run_cli(common + ["--init-from", str(src), "--iters", "1",
                                "--learning-rate", "0", "--batch-size", str(BATCH),
                                "--rollout", str(ROLLOUT)], capsys)
    want = _leaves(student)
    for path, leaf in _torch_leaves(res["student"]).items():
        if "'sn'" not in path:
            np.testing.assert_array_equal(leaf, want[path], err_msg=path)
    os.remove(out / "fidelity.json")
    res, run = _run_cli(common + ["--fidelity-only"], capsys)
    assert run["bce"] == [] and set(run["seconds"]) == {"fidelity"}
    with open(out / "fidelity.json") as f:
        fid = json.load(f)
    assert _key_tree(fid) == _key_tree(jax_records[1])
    assert fid["teacher_hash"] == jckpt.bundle_hash(teacher_dir)


def test_cli_needs_a_card_unless_platform_cpu(teacher_dir, tmp_path):
    """Without ``--platform cpu`` the command runs on the card, and raises
    where there is none (no fall-back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--env", ENV, "--teacher", teacher_dir, "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="--platform"):
        cli.main(["--env", ENV, "--teacher", teacher_dir, "--platform", "tpu",
                  "--out", str(tmp_path)])
