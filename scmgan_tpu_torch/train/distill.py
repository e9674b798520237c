"""The serving student's fidelity gate.

Port of ``measure_fidelity`` from ``scmgan_tpu/train/distill.py``: the
reference MSE protocol run on the same evaluation trajectories for the
teacher, the exact student transition and, with ``include_int8``, the
calibrated int8 student.  ``within_1pct`` is the serving gate: MSE@t+10 no
more than 1% worse than the teacher, scored on the engine that serves.  The
distillation and fine-tuning steps (``fake_quant_transition``,
``make_distill_step``, ``make_gt_finetune_step``) wait for ROADMAP Queue 1.5;
the train step they build on is ``train/trainer.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from scmgan_tpu_torch.analysis.mse import measure_prediction_mse
from scmgan_tpu_torch.models.quantized import (
    QuantizedTransition,
    calibrate_transition,
    transition_int8_v2,
)
from scmgan_tpu_torch.models.world_model import WorldModel, encode


def _generator(datasource, seed: int) -> torch.Generator:
    return torch.Generator(device=datasource.device).manual_seed(seed)


def calibrate_student(teacher: WorldModel, student_transition: dict,
                      datasource, seed: int = 0) -> QuantizedTransition:
    """The int8 serving student: calibrated on a batch of 64 x 30 drawn with
    ``seed + 777`` (encoded frames 0-2 thresholded at 0.5, actions 2-28),
    per-channel max over the 27-step exact free-run."""
    obs, _, _, actions = datasource.collect(
        64, 30, generator=_generator(datasource, seed + 777))
    a_oh = torch.nn.functional.one_hot(
        actions.long(), datasource.binary_input_channels).to(torch.float32)
    with torch.inference_mode():
        z_cal = (encode(teacher.encoder, obs[:, :3].to(torch.float32))
                 > 0.5).to(torch.float32)
    return calibrate_transition(student_transition, z_cal, a_oh[:, 2:29],
                                percentile=100.0)


def measure_fidelity(teacher: WorldModel, student_transition: dict, datasource,
                     out_dir: str, eval_batch_size: int = 100,
                     eval_timesteps: int = 30, seed: int = 0,
                     horizons: Tuple[int, ...] = (3, 5, 10, 20),
                     include_int8: bool = True,
                     eval_seed: Optional[int] = None) -> dict:
    """Paired MSE comparison: every run draws its batch from a generator
    freshly seeded with ``(eval_seed or seed) + 12345``, so all see the same
    trajectories.  The int8 student comes from ``calibrate_student``.
    Returns the fidelity record with the JAX package's keys.

    At batch 100 one MSE@t+10 estimate carries about 2.5% standard error
    (the JAX package's measurement), so one seed cannot resolve a 1% gate.
    """
    eval_seed = (seed if eval_seed is None else eval_seed) + 12345

    def run(name, model, transition_fn=None):
        sub = os.path.join(out_dir, name)
        os.makedirs(sub, exist_ok=True)
        return measure_prediction_mse(
            model, datasource, train_iter=1, batch_size=eval_batch_size,
            timesteps=eval_timesteps, out_dir=sub, make_plots=False,
            generator=_generator(datasource, eval_seed),
            transition_fn=transition_fn)[0]

    student = teacher._replace(transition=student_transition)
    mse_t = run("_t", teacher)
    mse_s = run("_s", student)
    hs = [h for h in horizons if h < min(len(mse_t), len(mse_s))]
    fid = {
        "eval_batch_size": eval_batch_size,
        "eval_timesteps": eval_timesteps,
        "teacher_mse": {h: mse_t[h] for h in hs},
        "student_mse": {h: mse_s[h] for h in hs},
        "delta_pct": {h: 100.0 * (mse_s[h] - mse_t[h]) / mse_t[h] for h in hs},
    }
    gate_delta = fid["delta_pct"].get(10)

    if include_int8:
        qt = calibrate_student(teacher, student_transition, datasource, seed)
        mse_q = run("_q", student,
                    lambda z, a: transition_int8_v2(qt, z, a).to(torch.float32))
        qh = [h for h in hs if h < len(mse_q)]
        fid["student_int8_mse"] = {h: mse_q[h] for h in qh}
        fid["int8_delta_pct"] = {
            h: 100.0 * (mse_q[h] - mse_t[h]) / mse_t[h] for h in qh}
        gate_delta = fid["int8_delta_pct"].get(10, gate_delta)

    fid["mse10_delta_pct"] = gate_delta
    fid["within_1pct"] = gate_delta is not None and gate_delta <= 1.0
    return fid
