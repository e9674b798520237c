"""Serving-student distillation of the transition, and its fidelity gate.

Port of ``scmgan_tpu/train/distill.py``: a width-H student transition is
trained to imitate a trained teacher's eval-mode latent dynamics (the
teacher's encoder, decoder and reward nets are kept verbatim), then gated
on the reference MSE protocol staying within 1% at t+10.

  * ``make_distill_step``: BCE between the student's deterministic sigmoid
    and the teacher's hard-thresholded next latents over the eval
    free-run's state distribution (z_0 the raw encoder output, then binary
    carries, actions from index 1), with the DAgger mix: per (step, sample)
    the next carry is, with probability ``p_on_policy``, the (pre-update)
    student's own hard-thresholded output, else the teacher's; labels are
    always the teacher's one-step output from the visited state.  With
    ``qat`` the student runs through ``fake_quant_transition``, the
    differentiable mirror of the calibrated int8 serving engine.
  * ``make_gt_finetune_step``: the gated metric itself, the done-masked
    free-run pixel MSE through the frozen teacher decoder, with the
    hard-binarized carry under a straight-through gradient.
  * ``measure_fidelity``: the paired MSE comparison of the teacher, the
    exact student and, with ``include_int8``, the calibrated int8 student.

Randomness comes in through a ``DistillNoise`` (the env rollout, the mix
mask, the calibration batch), in the pattern of ``train/losses.py``'s
``LossNoise``, so that a test can replay the JAX package's draws.  The
optimizer is ``optax.chain(optax.clip(0.1), optax.adam(cosine_decay))``
written with torch (``DistillOptimizer``).

Precision: these steps are training, and the JAX package runs them through
XLA's f32 convs, not through Pallas; the port runs them through plain
autograd convs and launches none of its kernels.  On the card the f32
convs run with PyTorch's default cuDNN TF32 (the JAX package's TPU default
precision is coarser still); a card-against-CPU comparison of a step runs
under ``utils/device.py::no_tf32``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from scmgan_tpu_torch.analysis.mse import measure_prediction_mse
from scmgan_tpu_torch.envs import rollout
from scmgan_tpu_torch.models.quantized import (
    QuantizedTransition,
    activation_scales,
    fold_calibrated,
    input_scales,
    transition_int8_v2,
)
from scmgan_tpu_torch.models.world_model import (
    WorldModel,
    decode,
    encode,
    transition,
)
from scmgan_tpu_torch.ops.conv import conv2d, leaky_relu
from scmgan_tpu_torch.ops.spectral_norm import sn_weight, update_spectral_norms
from scmgan_tpu_torch.train.trainer import trainable_leaves

CALIBRATION_BATCH = (64, 30)   # trajectories x steps of a calibration batch
CALIBRATION_ACTIONS = slice(2, 29)
GRAD_CLIP = 0.1                # the JAX script's optax.clip(0.1)
COSINE_ALPHA = 0.05            # and cosine_decay_schedule's final fraction


class DistillNoise:
    """Every random draw of the distillation steps and of the command
    line's recalibration, from ``generator`` on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def rollout(self, spec, batch_size: int, timesteps: int):
        """A random-policy trajectory batch (obs, rewards, dones, actions)."""
        return rollout(spec, self.generator, batch_size, timesteps, "random")

    def mix(self, p_on_policy: float, steps: int, batch_size: int) -> torch.Tensor:
        """(steps, B) bool: where the next carry is the student's."""
        g = self.generator
        return torch.rand((steps, batch_size), generator=g, device=g.device) < p_on_policy

    def calibration(self, datasource):
        """The calibration batch: ``datasource.collect(64, 30)``."""
        return datasource.collect(*CALIBRATION_BATCH, generator=self.generator)


def cosine_decay(step: int, decay_steps: int) -> float:
    """``optax.cosine_decay_schedule(1, decay_steps, alpha=COSINE_ALPHA)`` at
    update ``step``: (1 - alpha) * (1 + cos(pi * min(step, N) / N)) / 2 +
    alpha."""
    frac = min(step, decay_steps) / decay_steps
    return (1.0 - COSINE_ALPHA) * 0.5 * (1.0 + math.cos(math.pi * frac)) + COSINE_ALPHA


class DistillOptimizer:
    """``optax.chain(optax.clip(0.1), optax.adam(lr_schedule))`` on the
    student's trainable leaves: each gradient clamped element-wise to
    [-GRAD_CLIP, GRAD_CLIP], one ``torch.optim.Adam`` step, then the
    schedule's ``LambdaLR`` stepped, so that update k uses lr *
    ``cosine_decay(k)`` (update 0 the full lr).  ``decay_steps=None``: a
    constant lr.  A leaf the loss does not reach steps with a zero gradient,
    as optax steps it.  Marks the leaves as requiring gradients."""

    def __init__(self, student: dict, lr: float, decay_steps: Optional[int] = None):
        leaves = trainable_leaves(student)
        for leaf in leaves:
            leaf.requires_grad_(True)
        self.adam = torch.optim.Adam(leaves, lr=lr)
        self.schedule = None if decay_steps is None else torch.optim.lr_scheduler.LambdaLR(
            self.adam, lambda k: cosine_decay(k, decay_steps))

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        for group in self.adam.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                else:
                    p.grad.clamp_(-GRAD_CLIP, GRAD_CLIP)
        self.adam.step()
        if self.schedule is not None:
            self.schedule.step()


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Straight-through: forward ``q``, gradient of ``x``."""
    return x + (q - x).detach()


def _ste_round_clip(x: torch.Tensor) -> torch.Tensor:
    """Round half to even and clip to the int8 range, straight-through."""
    return _ste(x, torch.clamp(torch.round(x), -127, 127))


def fake_quant_transition(params: dict, act_scale: dict, z: torch.Tensor,
                          action_onehot: torch.Tensor) -> torch.Tensor:
    """The differentiable mirror of the int8 serving engine
    (``calibrate_transition`` + ``transition_int8_v2``): per-input-channel
    scales folded into the spectral-normed weights, per-output-channel
    symmetric int8 weights (the scale ``ws`` under ``detach``), every hidden
    activation requantized on its calibrated grid, all with straight-through
    rounding (half to even) so that the student trains through the grid
    (QAT).  Requantization multiplies by the reciprocal ``1 / act_scale``, as
    the serving epilogue does (``y / s`` differs in the last ulp and can flip
    a rounding tie); conv6's logits are not requantized.  ``act_scale`` is
    ``models/quantized.py::activation_scales`` of the current student.  f32
    sums, not the engine's int32 ones, so on its grid but not bit-exact.
    Returns the deterministic sigmoid."""
    b, h, w, latent = z.shape
    num_actions = action_onehot.shape[-1]
    a_map = action_onehot[:, None, None, :].to(z.dtype).expand(b, h, w, num_actions)
    in_scales = input_scales(act_scale, latent + num_actions)

    def qconv(name, x_int, requant=True):
        p = params[name]
        w_raw = sn_weight(p) if "sn" in p else p["w"]
        w_f = w_raw * in_scales[name].detach()[None, None, :, None]
        ws = (w_f.reshape(-1, w_f.shape[-1]).abs().amax(dim=0) / 127.0 + 1e-12).detach()
        w_deq = _ste_round_clip(w_f / ws) * ws            # the serving weight grid
        y = conv2d({"w": w_deq, "b": p["b"]}, x_int, circular=True)
        if not requant:
            return y
        rq = (1.0 / act_scale[name]).detach()
        return _ste_round_clip(leaky_relu(y) * rq)         # the next integer grid

    # conv1's inputs (binary latents, one-hot actions) are integers already
    h1 = qconv("conv1", torch.cat([z, a_map], dim=-1))
    h2 = qconv("conv2", h1)
    h3 = qconv("conv3", h2)
    h4 = qconv("conv4", h3)
    h5 = qconv("conv5", torch.cat([h4, h2], dim=-1))
    return torch.sigmoid(qconv("conv6", torch.cat([h5, h1], dim=-1), requant=False))


def _clip_probs(p: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(p, 1e-6, 1 - 1e-6)`` with its gradient: maximum then
    minimum, each splitting the gradient in half at a tie, as JAX's do."""
    lo = torch.tensor(1e-6, dtype=p.dtype, device=p.device)
    hi = torch.tensor(1.0 - 1e-6, dtype=p.dtype, device=p.device)
    return torch.minimum(torch.maximum(p, lo), hi)


def _one_hot(actions: torch.Tensor, num_actions: int) -> torch.Tensor:
    return F.one_hot(actions.long(), num_actions).to(torch.float32)


def make_distill_step(spec, teacher: WorldModel, optimizer: DistillOptimizer,
                      batch_size: int, rollout_len: int, qat: bool = False):
    """The distillation step ``(student, noise, p_on_policy[, act_scale]) ->
    (student, bce, bit_acc)`` (``make_distill_step`` of the JAX module).

    Each call draws a fresh trajectory batch of ``rollout_len + 2`` steps
    (``noise.rollout``), encodes frames 0-2 with the teacher, and rolls the
    carry out for ``rollout_len`` steps from action 1 with the per-(step,
    sample) mix ``noise.mix`` (step t takes the student's output where
    ``use_student[t - 1]``); the student in the data rollout is the
    pre-update one, outside the loss graph.  The loss is the mean BCE of the
    student's sigmoid, clipped to [1e-6, 1 - 1e-6], against the teacher's
    labels, over every visited (state, action); then the value clip, Adam,
    the schedule and the spectral-norm refresh.  ``qat`` scores and rolls out
    the fake-quant student on ``act_scale``'s grid.  ``optimizer`` is shared
    by the plain and the QAT step, as the JAX script shares its state.
    """

    def student_fwd(sp, z, a, act_scale):
        if qat:
            return fake_quant_transition(sp, act_scale, z, a)
        return transition(sp, z, a, train=True, deterministic=True)

    def distill_step(student: dict, noise: DistillNoise, p_on_policy: float = 0.0,
                     act_scale: Optional[dict] = None):
        if qat and act_scale is None:
            raise ValueError("the QAT step needs act_scale")
        obs, _, _, actions = noise.rollout(spec, batch_size, rollout_len + 2)
        a_oh = _one_hot(actions, spec.num_actions)                 # (B, T, A)
        with torch.no_grad():
            z = encode(teacher.encoder, obs[:, :3].to(torch.float32))
            use_student = noise.mix(p_on_policy, rollout_len, batch_size)   # (T, B)
            zs, acts, labels = [], [], []
            for t in range(1, rollout_len + 1):
                a = a_oh[:, t]
                y = transition(teacher.transition, z, a, train=False)
                if qat:
                    y_s = (student_fwd(student, z, a, act_scale) > 0.5).to(z.dtype)
                else:
                    y_s = transition(student, z, a, train=False)
                zs.append(z)
                acts.append(a)
                labels.append(y)
                z = torch.where(use_student[t - 1][:, None, None, None], y_s, y)
            zs, acts, labels = torch.cat(zs), torch.cat(acts), torch.cat(labels)

        optimizer.zero_grad()
        p = _clip_probs(student_fwd(student, zs, acts, act_scale))
        bce = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
        loss = bce.mean()
        bits = ((p > 0.5).to(torch.float32) == labels).to(torch.float32).mean()
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            student = update_spectral_norms(student)
        return student, loss.detach(), bits.detach()

    return distill_step


def make_gt_finetune_step(spec, teacher: WorldModel, optimizer: DistillOptimizer,
                          batch_size: int, horizon: int, qat: bool = True):
    """The ground-truth fine-tune step ``(student, noise[, act_scale]) ->
    (student, gate_mse, mean_mse)`` (``make_gt_finetune_step`` of the JAX
    module): the eval protocol's free-run pixel MSE as the loss.

    A batch of ``horizon + 3`` steps; frames 0-2 encoded by the teacher, one
    advance with action 1, then for t = 2 .. 2 + horizon - 1 the teacher's
    decoder scores the done-masked pixel MSE against frame t (the mask
    drops a trajectory from the step it ends on) and the carry advances
    with action t.  Each advance is the fake-quant student (``qat``) or its
    deterministic sigmoid, hard-binarized with a straight-through gradient;
    the whole rollout is backpropagated.  The loss is the mean over the
    scored steps; ``gate_mse`` is step 10's (the last one's below horizon
    11).  The JAX function checkpoints each step to bound its BPTT memory;
    this one keeps every step's activations (no ``torch.utils.checkpoint``)
    and skips the advance after the last scored step, which reaches no loss.
    """

    def fwd(sp, z, a, act_scale):
        p = (fake_quant_transition(sp, act_scale, z, a) if qat
             else transition(sp, z, a, train=True, deterministic=True))
        return _ste(p, (p > 0.5).to(p.dtype))

    def ft_step(student: dict, noise: DistillNoise, act_scale: Optional[dict] = None):
        if qat and act_scale is None:
            raise ValueError("the QAT fine-tune needs act_scale")
        obs, _, dones, actions = noise.rollout(spec, batch_size, horizon + 3)
        a_oh = _one_hot(actions, spec.num_actions)
        obs = obs.to(torch.float32)
        dones = dones.to(torch.float32)
        with torch.no_grad():
            z0 = encode(teacher.encoder, obs[:, :3])

        optimizer.zero_grad()
        z = fwd(student, z0, a_oh[:, 1], act_scale)
        active = torch.ones((obs.shape[0],), dtype=torch.float32, device=obs.device)
        mses = []
        for t in range(2, 2 + horizon):
            active = active * (1.0 - dones[:, t])
            pred = torch.sigmoid(decode(teacher.decoder, z))
            per_traj = ((obs[:, t] - pred) ** 2).mean(dim=(1, 2, 3))
            mses.append((active * per_traj).sum() / torch.clamp(active.sum(), min=1.0))
            if t < 1 + horizon:
                z = fwd(student, z, a_oh[:, t], act_scale)
        mses = torch.stack(mses)
        loss = mses.mean()
        gate = mses[10] if horizon > 10 else mses[-1]
        loss.backward()
        optimizer.step()
        with torch.no_grad():
            student = update_spectral_norms(student)
        return student, gate.detach(), loss.detach()

    return ft_step


def calibration_scales(teacher: WorldModel, student: dict, batch,
                       num_actions: int) -> dict:
    """``activation_scales`` of ``student`` on a calibration batch (obs,
    rewards, dones, actions) of 64 x 30 (the serving recipe): frames 0-2
    encoded by the teacher and thresholded at 0.5, then the per-channel max
    over the 27-step exact free-run under actions 2-28."""
    obs, _, _, actions = batch
    with torch.no_grad():
        z_cal = (encode(teacher.encoder, obs[:, :3].to(torch.float32)) > 0.5).to(torch.float32)
    return activation_scales(student, z_cal,
                             _one_hot(actions, num_actions)[:, CALIBRATION_ACTIONS])


def _generator(datasource, seed: int) -> torch.Generator:
    return torch.Generator(device=datasource.device).manual_seed(seed)


def calibrate_student(teacher: WorldModel, student_transition: dict,
                      datasource, seed: int = 0) -> QuantizedTransition:
    """The int8 serving student: ``calibration_scales`` on a batch drawn with
    ``seed + 777``, folded into the weights (``calibrate_transition``)."""
    batch = datasource.collect(*CALIBRATION_BATCH,
                               generator=_generator(datasource, seed + 777))
    num_actions = datasource.binary_input_channels
    act_scale = calibration_scales(teacher, student_transition, batch, num_actions)
    return fold_calibrated(student_transition, act_scale,
                           teacher.encoder["conv4"]["w"].shape[-1], num_actions)


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
