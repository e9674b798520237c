#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py`` on the CPU at a small size.

    python3 scripts/rehearse_chip_smoke.py               # every phase
    python3 scripts/rehearse_chip_smoke.py --train-only  # phase 6 alone
    python3 scripts/rehearse_chip_smoke.py --train-only --hidden 128 --batch 8
    python3 scripts/rehearse_chip_smoke.py --mpc-only    # phase 8 alone
    python3 scripts/rehearse_chip_smoke.py --cli-only    # phase 9 alone
    python3 scripts/rehearse_chip_smoke.py --zoo-only    # phase 10 alone
    python3 scripts/rehearse_chip_smoke.py --distill-only  # phase 11 alone
    python3 scripts/rehearse_chip_smoke.py --replay-only   # phase 12 alone

The script's control flow, shapes and checks run with every CUDA call
mapped to the CPU: ``torch.Generator(device="cuda")`` and
``Tensor.to("cuda")`` / ``.cuda()`` stay on the CPU, the kernel wrappers
take their plain versions (counted here as launches, as the card's wrappers
count them), the build, the kernels' shared-memory queries and ``ptxas``
report are stubbed, ``cuda_ms`` returns 1.0 and the profiler, which sees no
device on the CPU, is skipped.  Batches and the trained model are shrunk
(``--batch``, ``--hidden``); the MPC phase plays 2 episodes of a few steps
on a shallow beam, so its score floor is not held; the command-line phase
runs its Config shrunk the same way (the trained model at ``--hidden``, the
shipped bundles at their width), one causal run, 20 Higgins iterations,
and its subprocess with ``--platform cpu``; the student-making phase runs
its ``distill_student`` process in this one (so that its launches are
counted) at 4 iterations, B = 2, a B = 4 x 14 gate, without holding the
falling BCE or the gates; the host-replay phase stitches with the native
library built by ``cc`` here, at B = 4, with phase 6's training shrunk the
same way.  Every time it prints is a CPU time or a stub,
never a card's.  It finds faults of control flow before a card is used;
the numbers of the checks (losses, curves, round trips) are the CPU's.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import pathlib
import subprocess
import sys
import time
import types

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _is_cuda(dev) -> bool:
    return dev == "cuda" or (isinstance(dev, torch.device) and dev.type == "cuda")


def map_cuda_to_cpu():
    generator = torch.Generator

    class CpuGenerator(generator):
        def __new__(cls, device=None):
            return generator(device="cpu")

    to = torch.Tensor.to

    def to_cpu(self, *args, **kw):
        args = tuple("cpu" if _is_cuda(a) else a for a in args)
        if _is_cuda(kw.get("device")):
            kw["device"] = "cpu"
        return to(self, *args, **kw)

    torch.Generator = CpuGenerator
    torch.Tensor.to = to_cpu
    torch.Tensor.cuda = lambda self, *a, **k: self
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0


def counting(fn, counter):
    def wrapped(*args, **kw):
        counter.launches += 1
        return fn(*args, **kw)
    return wrapped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-only", action="store_true",
                    help="run phase 6 (training) alone")
    ap.add_argument("--mpc-only", action="store_true",
                    help="run phase 8 (MPC) alone")
    ap.add_argument("--cli-only", action="store_true",
                    help="run phase 9 (the command line) alone")
    ap.add_argument("--zoo-only", action="store_true",
                    help="run phase 10 (the env zoo and its bundles) alone")
    ap.add_argument("--distill-only", action="store_true",
                    help="run phase 11 (making a student) alone")
    ap.add_argument("--replay-only", action="store_true",
                    help="run phase 12 (the host data path) alone")
    ap.add_argument("--hidden", type=int, default=32, help="hidden width of the trained model")
    ap.add_argument("--batch", type=int, default=4, help="training batch")
    args = ap.parse_args()

    map_cuda_to_cpu()
    import chip_smoke as cs
    from scmgan_tpu_torch.agent import mpc, oracle
    from scmgan_tpu_torch.analysis import mse
    from scmgan_tpu_torch.cli import distill_student
    from scmgan_tpu_torch.cli import main as cli
    from scmgan_tpu_torch.data import datasource, replay
    from scmgan_tpu_torch.models import quantized
    from scmgan_tpu_torch.train import checkpoint

    cpu = lambda device="cuda": torch.device("cpu")  # noqa: E731
    datasource.resolve_device = cpu
    replay.resolve_device = cpu
    checkpoint.resolve_device = cpu
    oracle.resolve_device = cpu
    mse.fused_transition = counting(mse.fused_transition, cs.fused_transition)
    mpc.fused_transition = counting(mpc.fused_transition, cs.fused_transition)
    mse.fused_decode = counting(mse.fused_decode, cs.fused_decode)
    quantized.int8_transition = counting(quantized.int8_transition, cs.i8.int8_transition)
    cs.profile_device = lambda fn: (fn(), (1.0, 0.5, {"(no device on the CPU)": 1.0}))[1]
    cs.cuda_ms = lambda fn, iters=20, warmup=3: (fn(), 1.0)[1]
    config = cs.Config
    cs.Config = lambda **kw: config(**{**kw, "batch_size": args.batch,
                                       "hidden_dim": args.hidden})
    cs.BATCH, cs.CHECK_BATCHES, cs.EXTRA_BATCH = 4, (2, 4), 2
    cs.REPLAY_BATCHES = ((4, 10, True), (4, 14, False))
    cs.TIMESTEPS = cs.FIDELITY_TIMESTEPS = cs.TRAIN_EVAL_TIMESTEPS = 14
    cs.MPC_LOOKAHEAD, cs.MPC_DEPTH, cs.MPC_STEPS, cs.MPC_HOST_STEPS = 1, 2, 4, 4
    cs.MPC_GRID_EPISODES, cs.MPC_PONG_MAX_EPISODES, cs.MPC_AGREEMENT_STATES = 2, 2, 3
    cs.MPC_GRID_FLOOR = -float("inf")
    cs.MPC_CHECK_BATCHES, cs.MPC_TIME_SHAPES = (2, 4), ((16, 2), (64, 2))
    cli_config = cli.config_from_args

    def small_cli_config(a):
        fresh = a.load_from is None or "chip_smoke_cli_train_" in a.load_from
        return cli_config(a).replace(
            batch_size=args.batch, eval_batch_size=4, eval_timesteps=8, mpc_max_steps=4,
            mpc_lookahead=1, mpc_rollout_depth=2,
            **({"hidden_dim": args.hidden} if fresh else {}))

    cli.config_from_args = small_cli_config
    cli_main = cli.main
    cli.main = lambda argv: cli_main(argv + ["--causal-runs", "1", "--higgins-iters", "20"])
    run = subprocess.run

    def run_on_cpu(argv, **kw):
        argv = list(argv)
        if argv[1:3] == ["-m", "scmgan_tpu_torch.cli.distill_student"]:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                distill_student.main(argv[3:] + ["--platform", "cpu"])
            return types.SimpleNamespace(returncode=0, stdout=out.getvalue(), stderr="")
        return run(argv + ["--platform", "cpu"], **kw)

    cs.subprocess = types.SimpleNamespace(run=run_on_cpu)
    cs.DISTILL_ARGV = ["--env", cs.ENV, "--teacher", cs.BUNDLE, "--hidden", "48",
                       "--iters", "4", "--qat-from", "0.5", "--qat-recal", "1",
                       "--gt-iters", "2", "--gt-horizon", "12", "--batch-size", "2",
                       "--rollout", "3", "--gt-batch-size", "2", "--eval-seeds", "1"]
    cs.GATE_ARGV = ["--eval-batch-size", "4", "--eval-timesteps", "14"]
    cs.GATE_TIMESTEPS = 14
    cs.DISTILL_LOSS_WINDOW, cs.HOLD_GATE = 0, False
    cs.PROFILE_DISTILL = {"batch": 2, "rollout": 3, "horizon": 12}

    t0 = time.perf_counter()
    if args.train_only:
        ds = datasource.allocate_datasource(cs.ENV, seed=cs.SEED, device="cpu")
        print("launches", cs.train_phase(ds, 16)[0])
        rc = 0
    elif args.replay_only:
        model = cs.load_model(cs.BUNDLE, device="cuda")
        print("launches", cs.replay_phase(model, 16, ([1.0] * 20, [1.0] * 20), {},
                                          ["prediction_01_iter_000010.avi"])["launches"])
        rc = 0
    elif args.mpc_only:
        print("launches", cs.mpc_phase()["launches"])
        rc = 0
    elif args.cli_only:
        torch.cuda.is_available = lambda: True
        print("launches", cs.cli_phase()["launches"])
        rc = 0
    elif args.zoo_only:
        torch.cuda.is_available = lambda: True
        print("launches", cs.zoo_phase()["launches"])
        rc = 0
    elif args.distill_only:
        torch.cuda.is_available = lambda: True
        model = cs.load_model(cs.BUNDLE, device="cuda")
        student = cs.load_pytree(f"{cs.STUDENT}/model-transition.npz", "cuda")
        ds = datasource.allocate_datasource(cs.ENV, seed=cs.SEED, device="cpu")
        qt = cs.calibrate_student(model, student, ds, cs.SEED)
        print("launches", cs.distill_phase(model, student, qt, ds)["launches"])
        rc = 0
    else:
        torch.cuda.is_available = lambda: True
        torch.cuda.get_device_name = lambda *a: "CPU rehearsal"
        torch.cuda.device_count = lambda: 1
        cs.card_line = lambda: "CPU rehearsal (no card)"
        cs._build.build = lambda: pathlib.Path("rehearsal-without-a-build.so")
        cs._build.library = lambda: types.SimpleNamespace(
            scm_transition_smem=lambda n: 0, scm_int8_smem=lambda n: 0,
            scm_decode_smem=lambda: 0)
        cs._build.ptxas_report = lambda: []
        cs.faulthandler.dump_traceback_later = lambda *a, **k: None
        rc = cs.main()
    print(f"rehearsal rc {rc}, {time.perf_counter() - t0:.1f} s on the CPU")
    return rc


if __name__ == "__main__":
    sys.exit(main())
