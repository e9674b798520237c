"""Distill a trained transition into a narrower serving student.

    python -m scmgan_tpu_torch.cli.distill_student --env minipacman \
        --teacher pretrained_models/minipacman_cf --hidden 48 --iters 2000 \
        --qat-from 0.5 --gt-iters 500 --eval-seeds 4 --out runs/student_h48

Port of ``scripts/distill_student.py`` with its flags and defaults: the
distillation (``train/distill.py::make_distill_step``) with the on-policy
ramp, the QAT tail from ``--qat-from`` recalibrated every ``--qat-recal``
iterations, the ground-truth fine-tune (``--gt-iters``), ``--init-from``,
``--fidelity-only`` and the ``--eval-seeds`` aggregation of the fidelity
gate.  It writes, in the JAX package's layouts, ``<out>/model-transition.npz``
(the student), ``<out>/model-decoder.npz`` (the teacher's decoder, so that
the serving bundle is self-contained) and ``<out>/fidelity.json`` (the
gate's record with the run's settings and the teacher's ``bundle_hash``).
``--fidelity-only`` reads ``<out>/model-transition.npz`` and overwrites
the other two files in ``<out>``.

``--platform``: cuda by default, cpu on request; without a card and
without ``--platform cpu`` it raises.  The training steps run plain
autograd convs; the gate runs the transition, decoder and int8 kernels on
the card.  Randomness comes from one ``torch.Generator`` on the device,
seeded with ``--seed``, in place of the JAX script's key chain; the
evaluation batches come from ``measure_fidelity``'s own seeds.

Before the fidelity record it prints one JSON line ``{"run": ...}``: every
iteration's losses, each stage's wall seconds and ms per iteration, and
the kernel launches of each stage.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Distill a transition into a serving student (PyTorch/CUDA port)")
    p.add_argument("--env", default="minipacman")
    p.add_argument("--teacher", default="runs/minipacman_cf")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--iters", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--rollout", type=int, default=20,
                   help="teacher free-run length per sampled trajectory")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--on-policy-max", type=float, default=1.0,
                   help="final probability that the rollout carry is the "
                        "student's own state (DAgger mix; teacher labels)")
    p.add_argument("--on-policy-ramp", type=float, default=0.5,
                   help="fraction of iters over which p ramps 0 -> max")
    p.add_argument("--cosine-decay", action="store_true", default=True)
    p.add_argument("--no-cosine-decay", dest="cosine_decay", action="store_false")
    p.add_argument("--out", default=None)
    p.add_argument("--platform", default=None, help="cuda (the default) or cpu")
    p.add_argument("--fidelity-only", action="store_true",
                   help="skip training; re-measure fidelity of <out> (overwrites "
                        "<out>/fidelity.json and <out>/model-decoder.npz)")
    p.add_argument("--init-from", default=None,
                   help="warm-start the student from <dir>/model-transition"
                        ".npz (same hidden width) instead of fresh init")
    p.add_argument("--qat-from", type=float, default=None, metavar="FRAC",
                   help="switch to quantization-aware training (fake-quant "
                        "forward on the serving int8 grid) after this "
                        "fraction of iters")
    p.add_argument("--qat-recal", type=int, default=500,
                   help="recalibrate QAT activation scales from the "
                        "current student every N iters")
    p.add_argument("--gt-iters", type=int, default=0,
                   help="after distillation, fine-tune on the gated metric "
                        "itself: free-run pixel MSE vs ground truth under "
                        "the eval protocol (QAT forward, STE binary carry)")
    p.add_argument("--gt-horizon", type=int, default=16)
    p.add_argument("--gt-batch-size", type=int, default=16)
    p.add_argument("--gt-learning-rate", type=float, default=1e-4)
    p.add_argument("--eval-batch-size", type=int, default=100)
    p.add_argument("--eval-timesteps", type=int, default=30)
    p.add_argument("--eval-seeds", type=int, default=1,
                   help="aggregate the fidelity gate over N independent "
                        "paired evals (the @t+10 estimate carries ~2.5%% "
                        "standard error per 100 trajectories)")
    p.add_argument("--seed", type=int, default=0)
    return p


def _launches() -> dict:
    from scmgan_tpu_torch.ops.kernels.fused_decoder import fused_decode
    from scmgan_tpu_torch.ops.kernels.fused_transition import fused_transition
    from scmgan_tpu_torch.ops.kernels.int8_transition import int8_transition

    return {"fused_transition": fused_transition.launches,
            "fused_decode": fused_decode.launches,
            "int8_transition": int8_transition.launches}


def aggregate(per_seed: list) -> dict:
    """The ``--eval-seeds`` record: means over the seeds of each MSE curve,
    deltas from those means, the per-seed gate deltas and the standard error
    of their mean (the JAX script's aggregation)."""
    fid = dict(per_seed[0])
    if len(per_seed) == 1:
        return fid
    n = len(per_seed)
    for k in ("teacher_mse", "student_mse", "student_int8_mse"):
        if k in fid:
            fid[k] = {h: sum(f[k][h] for f in per_seed) / n for h in fid[k]}
    fid["delta_pct"] = {
        h: 100.0 * (fid["student_mse"][h] - fid["teacher_mse"][h]) / fid["teacher_mse"][h]
        for h in fid["teacher_mse"]}
    gate_key = "int8_delta_pct" if "student_int8_mse" in fid else "delta_pct"
    if "student_int8_mse" in fid:
        fid["int8_delta_pct"] = {
            h: 100.0 * (fid["student_int8_mse"][h] - fid["teacher_mse"][h])
            / fid["teacher_mse"][h] for h in fid["teacher_mse"]}
    deltas10 = [f["mse10_delta_pct"] for f in per_seed]
    fid["mse10_delta_pct"] = fid[gate_key].get(10)
    fid["mse10_delta_per_seed"] = deltas10
    mean = sum(deltas10) / n
    fid["mse10_delta_se_pct"] = math.sqrt(sum((d - mean) ** 2 for d in deltas10)
                                          / (n - 1) / n)
    fid["eval_seeds"] = n
    fid["within_1pct"] = (fid["mse10_delta_pct"] is not None
                          and fid["mse10_delta_pct"] <= 1.0)
    return fid


def main(argv=None) -> dict:
    """Run the command line on ``argv``.  Returns the ``student`` transition,
    the ``fidelity`` record and the ``run`` record that it prints."""
    args = build_parser().parse_args(argv)

    from scmgan_tpu_torch.cli.main import platform_device
    from scmgan_tpu_torch.config import Config
    from scmgan_tpu_torch.data.datasource import allocate_datasource
    from scmgan_tpu_torch.models.world_model import init_transition
    from scmgan_tpu_torch.train import checkpoint as ckpt
    from scmgan_tpu_torch.train.distill import (
        DistillNoise,
        DistillOptimizer,
        calibration_scales,
        make_distill_step,
        make_gt_finetune_step,
        measure_fidelity,
    )

    device = platform_device(args.platform)
    out_dir = args.out or f"runs/{args.env}_student_h{args.hidden}"
    os.makedirs(out_dir, exist_ok=True)
    student_file = os.path.join(out_dir, "model-transition.npz")

    ds = allocate_datasource(args.env, seed=args.seed, device=device)
    spec = ds.spec
    cfg = Config(env=args.env)
    teacher = ckpt.load_model(args.teacher, device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    noise = DistillNoise(generator)
    student = init_transition(generator, cfg.latent_dim, spec.num_actions,
                              hidden=args.hidden)
    if args.init_from:
        student = ckpt.load_pytree(os.path.join(args.init_from, "model-transition.npz"),
                                   device, template=student)

    def recalibrate(sp):
        return calibration_scales(teacher, sp, noise.calibration(ds), spec.num_actions)

    run = {"bce": [], "bit_acc": [], "qat_start": None, "gt_gate_mse": [],
           "gt_mean_mse": [], "seconds": {}, "ms_per_iter": {}, "launches": {}}

    def stage(name, t0, before, iters=None):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        run["seconds"][name] = time.perf_counter() - t0
        run["launches"][name] = {k: v - before[k] for k, v in _launches().items()}
        if iters:
            run["ms_per_iter"][name] = 1e3 * run["seconds"][name] / iters

    if not args.fidelity_only:
        t0, before = time.perf_counter(), _launches()
        optimizer = DistillOptimizer(student, args.learning_rate,
                                     args.iters if args.cosine_decay else None)
        distill_step = make_distill_step(spec, teacher, optimizer, args.batch_size,
                                         args.rollout)
        qat_start = (args.iters if args.qat_from is None
                     else max(0, int(args.qat_from * args.iters)))
        # the QAT step continues the same optimizer state
        distill_step_qat = make_distill_step(spec, teacher, optimizer, args.batch_size,
                                             args.rollout, qat=True)
        ramp_iters = max(1, int(args.on_policy_ramp * args.iters))
        act_scale = None
        losses, bits = [], []
        for it in range(args.iters):
            p_on = args.on_policy_max * min(1.0, it / ramp_iters)
            if it >= qat_start:
                if act_scale is None or (it - qat_start) % args.qat_recal == 0:
                    act_scale = recalibrate(student)
                student, loss, bit = distill_step_qat(student, noise, p_on, act_scale)
            else:
                student, loss, bit = distill_step(student, noise, p_on)
            losses.append(loss)
            bits.append(bit)
            if it % 100 == 0 or it == args.iters - 1:
                tag = " QAT" if it >= qat_start else ""
                print(f"iter {it:5d}  bce {float(loss):.5f}  bit-acc {float(bit):.5f}  "
                      f"p_on {p_on:.2f}{tag}  ({time.perf_counter() - t0:.1f}s)",
                      flush=True)
        if losses:
            run["bce"] = torch.stack(losses).tolist()
            run["bit_acc"] = torch.stack(bits).tolist()
        run["qat_start"] = qat_start
        ckpt.save_pytree(student_file, student)
        stage("distill", t0, before, args.iters)
    else:
        student = ckpt.load_pytree(student_file, device, template=student)

    if args.gt_iters > 0 and not args.fidelity_only:
        t0, before = time.perf_counter(), _launches()
        optimizer = DistillOptimizer(student, args.gt_learning_rate,
                                     args.gt_iters if args.cosine_decay else None)
        ft_step = make_gt_finetune_step(spec, teacher, optimizer, args.gt_batch_size,
                                        args.gt_horizon, qat=True)
        act_scale = None
        gates, means = [], []
        for it in range(args.gt_iters):
            if act_scale is None or it % args.qat_recal == 0:
                act_scale = recalibrate(student)
            student, gate, mean_mse = ft_step(student, noise, act_scale)
            gates.append(gate)
            means.append(mean_mse)
            if it % 50 == 0 or it == args.gt_iters - 1:
                print(f"gt-ft {it:5d}  mse@gate {float(gate):.6f}  "
                      f"mean {float(mean_mse):.6f}  ({time.perf_counter() - t0:.1f}s)",
                      flush=True)
        run["gt_gate_mse"] = torch.stack(gates).tolist()
        run["gt_mean_mse"] = torch.stack(means).tolist()
        ckpt.save_pytree(student_file, student)
        stage("gt_finetune", t0, before, args.gt_iters)

    t0, before = time.perf_counter(), _launches()
    per_seed = []
    for i in range(max(1, args.eval_seeds)):
        with torch.no_grad():
            fid_i = measure_fidelity(
                teacher, student, ds, out_dir, eval_batch_size=args.eval_batch_size,
                eval_timesteps=args.eval_timesteps, seed=args.seed,
                eval_seed=args.seed + 7919 * i)
        per_seed.append(fid_i)
        print(f"eval seed {i}: mse10_delta_pct {fid_i['mse10_delta_pct']:.3f}", flush=True)
    fid = aggregate(per_seed)
    stage("fidelity", t0, before)
    fid.update(env=args.env, teacher=args.teacher, hidden=args.hidden,
               iters=args.iters, qat_from=args.qat_from,
               # the hash of the teacher this gate was measured against
               teacher_hash=ckpt.bundle_hash(args.teacher))
    with open(os.path.join(out_dir, "fidelity.json"), "w") as f:
        json.dump(fid, f, indent=2)
    ckpt.save_pytree(os.path.join(out_dir, "model-decoder.npz"), teacher.decoder)
    print(json.dumps({"run": run}), flush=True)
    print(json.dumps(fid, indent=2), flush=True)
    return {"student": student, "fidelity": fid, "run": run}


if __name__ == "__main__":
    main()
