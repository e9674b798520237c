#!/usr/bin/env python3
"""Smoke test of the PyTorch/H100 port (``scmgan_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, on a CUDA machine

Phases:
  1. device: the card's name and power limit (nvidia-smi); TF32 off, so the
     plain PyTorch versions compute in full f32;
  2. build: the CUDA sources, one nvcc each, all started together (cached
     by source hash in build/scmgan_tpu_torch/), and each kernel's
     registers, shared memory and spill bytes (ptxas -v), the int8 kernel's
     translation units (``conv3x3_s8<N,split>``) included;
  3. each kernel against its plain version on the card, element by
     element, at full width (minipacman_cf: latent 16, hidden 128, 64x64x3
     frames, 5 actions, 2 rewards; the minipacman_student_h48 transition,
     hidden 48), at B = 8 and at the main paths' B = 100: the bf16
     transition at hidden 128 and 48, the decoder, and the int8 transition
     in its three packings (the calibrated h48 student with joint conv5/6
     scales; the teacher's static split-half packings of
     ``quantized_transition`` and ``int8_fused_transition``); at B = 8 the
     shapes the main paths do not reach: the bf16 transition at hidden 64
     and 80 (minipacman_student_h64/h80), conv1 with 4 actions (pong_cf's
     transition, 20 input channels), the 1-colour decoder of boxes_cf, the
     int8 kernel at hidden 64 and 80 (static joint and split packings of
     the same students); and both bf16 kernels and every int8 packing on a
     12x12 batch;
  4. the first main path: ``measure_prediction_mse`` on the minipacman_cf
     bundle, B = 100 trajectories x 100 steps, with launch counts read
     around it and its first steps held against the plain path; then one
     free-run under torch.profiler: the card's busy share and the kernels
     that take its time;
  5. the second main path: the student fidelity gate ``measure_fidelity``
     (teacher, exact h48 student, calibrated int8 h48 student; B = 100 x 30
     steps), with launch counts read around it, its record printed beside
     the JAX package's recorded one, and the int8 run's pixel-MSE curve held
     against the plain int8 version on the same batch; then, printed only,
     the gate's MSE@t+10 with the teacher and exact student through the
     plain f32 transition and decoder on that batch (the record's engines
     run the bf16 kernels; JAX scores them in f32);
  6. the third main path, training: ``trainer.train`` from a seeded
     ``init_train_state`` at full width and the Config defaults (B = 32,
     bf16 compute, lr 1e-4) for 24 iterations (horizon 3 -> 10, both CF
     regularizers with 2-step roll-outs, firing at 5/10/15/20), each
     iteration's ms and the peak device memory printed, every loss finite
     and the per-step reconstruction loss lower over the last 4 iterations
     than over the first 4; its evaluation hook (before the last step) runs
     ``measure_prediction_mse`` at B = 100 x 30 through the bf16 transition
     and decoder kernels on the trained weights, with launch counts read
     around ``train`` and its first 10 steps held against the plain path;
     then one f32 step (B = 2, horizon 4, TF32 off) on the card against the
     same step on the CPU (same weights, batch and uniforms); one step each
     with latent overshooting and latent TD at horizon 10, B = 32 (ms, peak
     memory); a bit-equal ``save_model`` / ``load_model`` round trip; and
     one horizon-10 step under torch.profiler (busy share, top kernels);
  7. each kernel's time against its plain version, a library yardstick where
     PyTorch has one, and its bound, at the main paths' shapes (B = 100);
     beside each int8 row the int8 kernel in all three epilogue orders and
     the bf16 kernel at the same hidden width;
  8. the fourth main path, MPC (agent/): (a) both transition kernels at
     16x16 against their plain versions (gridworld_cf, B = 4, 64 and 640;
     the bf16 kernel's both heads, the int8 kernel in the calibrated and
     the static packing, bit for bit); (b) ``play_on_device`` on
     gridworld_cf with the records' reference beam (lookahead 2, depth 12),
     10 episodes x 300 steps, each score printed and the mean held at
     >= 280 (record +291.7 +- 0.94; random +0.07 +- 8.0); (c) the bf16
     kernel's launch count of that run equal to the loop's implied count;
     (d) the true-dynamics oracle on the same episodes' protocol, beside its
     record; (f) ms per plan on pong_cf_60k for the bf16 kernel, the int8
     kernel (``calibrated_qt``) and the plain f32 route, the argmax
     agreement of both kernels with the plain route over 50 states, and one
     profiled plan (busy share, top kernels); (e) as many 300-step
     pong_cf_60k episodes as fit in about 60 s, printed beside the record
     (not held: the SE is too large at that n); (g) one
     ``rollout_samples=4`` plan (the Bernoulli head) and one 50-step host
     ``play`` episode on the int8 beam writing its score file; then both
     kernels' per-call times at the MPC shapes (16x16 and 64x64; B = 4, 64,
     640) beside plain, cuDNN and the bound;
  9. the fifth main path, the command line (``scmgan_tpu_torch.cli.main``
     called in this process, the launch counters read around every run and
     each run's wall seconds printed): (a) train minipacman at full width,
     B = 32, 12 iterations with the evaluation (B = 100 x 30, videos) and
     the checkpoint at iteration 10: every loss finite, every artifact on
     disk, the launches the evaluation implies; (b) resume from that
     directory, the loaded parameters, Adam moments and step bit-equal to
     the saved state; (c) ``--evaluate`` on gridworld_cf: 3 playthroughs
     (mean held at >= 280), the evaluation with its videos, the causal
     graph and both Higgins variants, each printed beside its record, the
     launches the runs imply; (d) ``--mpc-int8`` play on pong_cf_60k, the
     int8 kernel's launches equal to the loop's count; (e) the h48 student
     served through ``--student``; (f) a directory of the reference's
     ``.pth`` files, its MSE curve beside the shipped one; then one
     ``python -m scmgan_tpu_torch`` run in its own process, which must
     exit 0 and write its checkpoint;
  10. the sixth main path, the env zoo and the shipped bundles of its envs
     (``zoo_phase``): (a) each of the twelve envs ported last (boxes,
     pong family, roomba, gameoflife) reset on the CPU at B = 100, copied
     to the card and stepped 40 times on both under the same actions,
     state, reward, done and frame equal (rotating_boxes' edge pixels
     excepted), ms per card step printed; (b) both bf16 kernels against
     their plain versions on boxes_cf (1 colour) and minipong_cf (3
     colours) at B = 1, 100 and the reconstruction windows' batches, and
     the transition with 1 action (17 conv1 inputs, a gameoflife model);
     (c) ``--evaluate --evaluations 0 --higgins`` on boxes_cf and
     minipong_cf in this process, launches held to the implied count, the
     free-run timed alone and its first steps held against the plain path
     (5%), the curve and Higgins accuracies printed beside the records;
     (d) ``python -m scmgan_tpu_torch.analysis.sanity`` on minipong_cf in
     its own process, its PNG on disk; (e) ``visualize_bptt`` on
     gridworld_cf, pong_cf and minipacman_cf, seeds 0-7, the first seed
     that fires printed, at least one bundle firing;
  11. the seventh main path, making a student (``distill_phase``): (a) the
     int8 variants halo / split / ring with the f32 epilogue bit-equal to
     the int8 kernel at B = 100, 64x64, on minipacman_cf's static packing
     and the h48 student's calibrated one (the bf16 epilogue's agreement
     and each variant's plain-route ms printed), ``decode_int8`` bit-equal
     to the CPU and within the serving MAE of the decoder kernel (its max
     printed beside the exact decoder's); (b) one distillation, one
     QAT and one GT fine-tune step (B = 2) card against CPU, TF32 off;
     (c) ``python -m scmgan_tpu_torch.cli.distill_student`` in its own
     process: an h48 student from minipacman_cf (60 iterations, QAT from
     30, 20 GT iterations, one gate seed), its BCE falling, its files, the
     teacher's hash and decoder, launches 0 in training and the gate's
     implied count; (c') each step kind at the script's defaults in this
     process, at PyTorch's default precision as the command runs them (cuDNN
     TF32 on): ms a step, the rollout's share, peak memory, one profiled
     step (busy share, kernel families); (d) ``--fidelity-only
     --eval-seeds 4`` on copies of the three shipped students, each
     calibrated packing held bit-equal to the
     plain int8 version first, within_1pct held, the 4-seed delta printed
     beside each record, nothing written under pretrained_models/;
     (e) the library ops (CSRN, CoordConv, smoothing, random_eps,
     hypersphere_norm, cov) card against CPU;
  12. the eighth main path, the host data path (``replay_phase``): (a) the
     native C library (stitcher, AVI writer) built with ``cc`` from the
     checkout's sources, timed in a fresh directory; (b) actors playing the
     port's minipacman on the host (``HostEnv`` on the CPU, a seeded random
     policy) into a ``HostReplayDatasource`` (capacity 50, episodes up to
     150 steps), episodes/s and frames/s over a fixed window with 1 and 2
     actors; (c) on a snapshot of the buffers, ``collect(32, 10)`` and
     ``collect(100, 100, training=False)`` on the card bit-equal to
     ``get_trajectories`` of the same seed moved NHWC, every stitched clip a
     run of one stored episode with its done at the end, ms per batch of the
     native stitcher, the plain Python loop and the copy to the card;
     (d) ``trainer.train`` from the buffer as phase 6 runs it (24
     iterations, B = 32, horizon 3 -> 10) with the actors playing: ms per
     iteration beside phase 6's, peak memory, finite and falling losses,
     the evaluation hook (test split, B = 100 x 30) held to 29 / 28 / 0
     launches and its first steps to the plain path, one profiled iteration
     (busy share, the host's stitch and copy shares); (e) the minipacman_cf
     free-run on the test split at B = 100 x 100, held to 99 / 98 / 0
     launches and the plain path, its curves beside phase 4's; (f) a video
     written as an uncompressed AVI (RIFF header, frame count) and phase
     9's evaluation videos held to ``.avi``; (g) the host backends of the
     machine: without gym, the ImportError each of gym:CarRacing-v3, atari
     and centipede raises, and sc2_star_intruders' env constructor's (with
     gym, a CarRacing collect and one train step on the card); (h) no actor
     thread alive after ``close()``;
  13. the ninth main path, the device mesh (``mesh_phase``; one card, so a
     one-process NCCL group: NCCL refuses two processes on one device, and
     multi-process meshes are held in the CPU tests): (a) ``python -m
     scmgan_tpu_torch --mesh 1x1`` in its own process on minipacman at full
     width (B = 32, 12 iterations, the evaluation hook before the last),
     every iteration's metrics equal to the same run without ``--mesh``
     (rtol 1e-6), the kernels' launches the hook implies (the kernels
     line's ``mesh`` path), its checkpoint loaded unsharded (the two
     processes run together); (b) in this
     process the sharded step at (1, 1) against the plain step, 10
     iterations each from one state and seed (the two alternating step by
     step), losses and parameters equal,
     ms per iteration and peak memory of both; (c) ``pipeline_transition``
     over three streams of the card with minipacman_cf's transition at
     B = 100, 64x64, 1, 2 and 4 microbatches, TF32 off: probabilities
     within 1e-5 of the unsharded transition's, bits equal except where
     |p - 0.5| <= 1e-5 (counted), ms per call beside the unsharded cuDNN
     transition and the ``fused_transition`` kernel; (d) the spatial
     transition on the one-process ring bit-equal to the unsharded one;
  14. every model shape (``shapes_phase``; both transition kernels run any
     width at the next multiple of 16 on zero-padded operands, a layer past
     128 channels as several output-channel tiles, and take any latent and
     action count; the decoder any latent): (a) the three kernels against
     their plain versions with random weights -- the transitions at hidden
     16, 32, 50, 96, 104 and 112 with 5 actions, at hidden 128 with 18, at
     hidden 144, 200 and 256 and at latents 4, 8, 32 and 64 (latent 64 at
     hidden 256 with 18 actions), at B = 100, 64x64 and B = 640, 16x16 (the
     bf16 kernel's two heads to phase 3's tolerance; the int8 kernel in a
     ``calibrated_qt`` packing and the three static ones, 0 bits apart);
     the decoder at latents 4, 8, 32 and 64 with 1 and 3 colours -- each
     call's launch counted; (b)
     ``python -m scmgan_tpu_torch.cli.distill_student --hidden 96`` on
     minipacman_cf in this process (20 iterations, one gate seed): its
     ``fidelity.json`` written, its gate's launches as implied, the gate
     delta printed, not held; (c) ``--env centipede`` (18 actions) on a
     stand-in ALE that this script puts in ``sys.modules`` (the machine has
     no ``atari_py``): 4 training iterations at the Config's width with the
     evaluation hook, then ``--evaluate --evaluations 0``, launches as
     implied, the free-run's first 10 steps held against the plain path
     (5%), and one timed plan at the records' reference beam (lookahead 2,
     depth 12: 5,832 beams) through the bf16 kernel; (d) a latent-8
     gridworld model (tests/test_train.py's configuration) trained 4
     iterations through ``trainer.train``, ``measure_prediction_mse`` at B =
     100 x 100 with its launches and its first 10 steps held against the
     plain path (5%), one plan each on the bf16 and the int8 kernel at the
     reference beam, launches held; (e) a random minipacman model at latent
     32, hidden 256, the same free-run at full size against the plain path,
     with its peak memory;
  15. a ``kernels`` JSON line (launches summed over the main paths), the
     card line, and the result line.

Phase 7 also times both transition kernels at hidden 16, 32, 50, 96, 104,
112, 144 and 256 and at latents 8 and 32 (hidden 128), and the decoder at
latents 8, 32 and 64 (random weights, 5 actions, B = 100, 64x64), beside
the plain versions, cuDNN and the bound.

Any failed check raises, so the script exits non-zero and prints no result
line.  Without a CUDA device, or outside the repository, it fails at once.
A watchdog ends a hang with a traceback and a non-zero exit (armed for
phases 1-8, and again for phases 9, 10, 11, 12, 13 and 14).
"""

from __future__ import annotations

import contextlib
import faulthandler
import functools
import inspect
import io
import itertools
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from scmgan_tpu_torch.agent.mpc import (
    calibrated_qt,
    make_planner,
    plan_steps,
    rollout_reward_table,
)
from scmgan_tpu_torch.agent.oracle import play_oracle_on_device
from scmgan_tpu_torch.agent.play import play
from scmgan_tpu_torch.agent.play_device import _episode_chunk, play_on_device
from scmgan_tpu_torch.analysis import excitation_bptt, visualize
from scmgan_tpu_torch.analysis.mse import _free_run_stats, measure_prediction_mse
from scmgan_tpu_torch.analysis.video import Video
from scmgan_tpu_torch.cli import distill_student
from scmgan_tpu_torch.cli import main as cli
from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch import native
from scmgan_tpu_torch.data.datasource import allocate_datasource
from scmgan_tpu_torch.data.replay import HostReplayDatasource, to_device_batch
from scmgan_tpu_torch.envs import HostEnv, get_env, rollout
from scmgan_tpu_torch.envs.host.gym_compat import import_gym
from scmgan_tpu_torch.envs.boxes import rotbox_crosses
from scmgan_tpu_torch.models.quantized import (
    decode_int8,
    quantize_decoder,
    quantize_transition,
    transition_int8,
    transition_int8_halo,
    transition_int8_ring,
    transition_int8_split,
    transition_int8_v2,
)
from scmgan_tpu_torch.ops import coordconv, csrn, smoothing
from scmgan_tpu_torch.ops.kernels import _build
from scmgan_tpu_torch.ops.kernels import int8_transition as i8
from scmgan_tpu_torch.ops.kernels.fused_decoder import (
    decode_plain,
    fused_decode,
    pack_decoder_weights,
)
from scmgan_tpu_torch.ops.kernels.fused_transition import (
    N_TILES,
    fused_transition,
    kernel_hidden,
    n_tiles,
    pack_transition_weights,
    philox_uniform,
    transition_plain,
    transition_probs,
)
from scmgan_tpu_torch.models.world_model import (
    WorldModel,
    decode,
    encode,
    init_decoder,
    init_transition,
    init_world_model,
    transition,
)
from scmgan_tpu_torch.parallel import distributed
from scmgan_tpu_torch.parallel.mesh import gather_pytree, make_mesh, spatial_transition
from scmgan_tpu_torch.parallel.pipeline import pipeline_transition
from scmgan_tpu_torch.train import checkpoint as ckpt
from scmgan_tpu_torch.train import distill, trainer
from scmgan_tpu_torch.train.checkpoint import (
    flatten_tree,
    load_model,
    load_pytree,
    save_model,
)
from scmgan_tpu_torch.train.distill import calibrate_student, measure_fidelity
from scmgan_tpu_torch.train.losses import LossNoise
from scmgan_tpu_torch.ops.stochastic import hypersphere_norm, random_eps
from scmgan_tpu_torch.utils import stats
from scmgan_tpu_torch.utils.device import no_tf32

WATCHDOG_S = 300
BUNDLE = "pretrained_models/minipacman_cf"
STUDENT = "pretrained_models/minipacman_student_h48"
# Shapes the main paths do not reach, checked at B = 8: the other student
# widths, conv1 with 4 actions (20 input channels), a 1-colour decoder.
EXTRA_TRANSITIONS = ("pretrained_models/minipacman_student_h64",
                     "pretrained_models/minipacman_student_h80",
                     "pretrained_models/pong_cf")
EXTRA_DECODER = "pretrained_models/boxes_cf"
# The int8 kernel at the other student widths: static joint and split
# packings (no calibrated packing ships at these widths).
EXTRA_INT8 = ("pretrained_models/minipacman_student_h64",
              "pretrained_models/minipacman_student_h80")
EXTRA_BATCH = 8
ENV = "minipacman"
SEED = 20261017
BATCH = 100
CHECK_BATCHES = (8, BATCH)
# A batch of 12 x 12 images: the transition kernels' tiles then hold 144
# pixels of 256 (120 of 128 in the int8 kernel's split-order tiles) and the
# decoder's 12 x 12 of 16 x 32; at 64 x 64 every tile is full.
RAGGED = (3, 12)
TIMESTEPS = 100
COMPARE_STEPS = 10
FIDELITY_TIMESTEPS = 30    # the settings of the student's fidelity.json

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, HBM3 rate.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12

# Tolerances, each with its reason:
# - threshold head: kernel and plain version both multiply bf16 exactly and
#   sum in f32, in another order; a bf16 rounding of an activation can differ
#   by one ulp, which moves a logit by far less than 0.08 (|p - 0.5| < 0.02).
#   A flipped bit is allowed only where the plain version's p is that close.
EPS_P = 0.02
# - sample head: the kernel's Philox uniforms are reproduced bit for bit on
#   the host, so a sampled bit may differ only where |u - p| < EPS_P; and the
#   samples' sum must lie within 6 binomial standard deviations of sum(p).
BINOMIAL_SIGMAS = 6.0
# - decoder: bf16 logits (8-bit mantissa) after a bf16 intermediate: at most
#   a few ulps, |kernel - plain| <= 0.02 + 0.02 |plain|.
DECODE_ATOL = DECODE_RTOL = 0.02
# - free-run pixel MSE, first steps: a latent bit that flips near p = 0.5
#   changes one of the 100 trajectories from there on; the batch mean moves
#   by a few percent at most.  The absolute floor lies well below the
#   first step's MSE (a reconstruction, far smaller than the later steps),
#   so that step too is held by the relative limit.
CURVE_RTOL = 0.05
CURVE_ATOL = 1e-6
# - int8 transition: integer sums are exact and the epilogue repeats the
#   plain version's f32 roundings, so threshold bits must agree exactly.
#   The sample head's p comes from the kernel's expf and the plain
#   version's torch.sigmoid (a few ulps apart): a sampled bit may differ
#   only where |u - p| < EPS_U.
EPS_U = 1e-6
# - int8 free-run: the same latents and the same decoder kernel on both
#   sides, so the curves agree up to the host's float sums.
INT8_CURVE_RTOL = 1e-6
# - training, the f32 step on the card against the same step on the CPU
#   (TF32 off): the convs sum in other orders, about 1e-6 relative per op,
#   so the loss and metrics agree to 1e-4 relative; a sampled latent bit
#   may flip where |u - p| is that small (about one of the step's 2.6e5
#   draws), which moves a loss term by about 1e-5 and a network's gradient
#   norm by about 1e-4, so those agree to 1e-3.  A fresh Adam's first step
#   moves each parameter by lr * sign(g): the updated parameters agree to
#   1e-6 wherever the two gradients have one sign, and no parameter is more
#   than 2 lr + 1e-6 apart.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_NORM_RTOL = 1e-3
TRAIN_PARAM_ATOL = 1e-6
TRAIN_SIGN_FLIP_FRACTION = 1e-3
TRAIN_ITERS = 24           # horizon_at walks 3 -> 10; CF fires at 5/10/15/20
TRAIN_EVAL_TIMESTEPS = 30
INT8_PACKINGS = {   # static quantization in each epilogue order
    "joint": lambda params: quantize_transition(params).packed,
    "sum_first": i8.pack_quantized_weights,
    "bias_first": i8.pack_int8_weights,
}
INT8_ENTRIES = {
    # TPU kernel -> (file:line of its pallas_call, the packing of its operands)
    "quantized_transition": ("scmgan_tpu/ops/pallas/quantized_transition.py:199",
                             i8.pack_quantized_weights),
    "int8_fused_transition": ("scmgan_tpu/ops/pallas/int8_kernel.py:201",
                              i8.pack_int8_weights),
}


def say(*args):
    print(*args, flush=True)


def counters() -> dict:
    """The kernel wrappers' launch counts."""
    return {"fused_transition": fused_transition.launches,
            "fused_decode": fused_decode.launches,
            "int8_transition": i8.int8_transition.launches}


def zero_counters():
    fused_transition.launches = 0
    fused_decode.launches = 0
    i8.int8_transition.launches = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def binary_latents(rng, b, hw=64, latent=16):
    z = (rng.random((b, hw, hw, latent)) > 0.5).astype(np.float32)
    return torch.from_numpy(z).cuda()


def onehot_actions(rng, b, num_actions):
    a = np.eye(num_actions, dtype=np.float32)[rng.integers(0, num_actions, b)]
    return torch.from_numpy(a).cuda()


@functools.lru_cache(maxsize=16)
def host_uniforms(seed: int, shape: tuple) -> torch.Tensor:
    """The kernels' sample-head uniforms for ``shape``, drawn by the host's
    Philox once per seed and shape (a second or so at B = 100, 64x64)."""
    return torch.from_numpy(philox_uniform(seed, shape))


def check_transition(pt, z, a, latent, label=""):
    """Hold the bf16 transition kernel against its plain bf16 version,
    element by element, on latents ``z`` and one-hot actions ``a``; raise
    on a miss."""
    bf16 = torch.bfloat16
    b = z.shape[0]
    with torch.inference_mode():
        p = transition_probs(pt, z, a, dtype=bf16)[..., :latent]
        got = fused_transition(pt, z, a)
        torch.cuda.synchronize()
        want = transition_plain(pt, z, a, dtype=bf16)
        flips = got != want
        n_flips = int(flips.sum())
        worst = float((p[flips] - 0.5).abs().max()) if n_flips else 0.0
        say(f"[check] B={b} transition{label} threshold: {n_flips} of "
            f"{got.numel()} bits differ; largest |p-0.5| among them "
            f"{worst:.3g} (limit {EPS_P})")
        if n_flips and worst >= EPS_P:
            raise AssertionError("transition threshold head disagrees")
        t_err = float((got - want).abs().max())

        seed = SEED % (1 << 31)
        got_s = fused_transition(pt, z, a, sample=True, seed=seed)
        u = host_uniforms(seed, (*z.shape[:3], pt["latent_pad"])).cuda()
        want_s = transition_plain(pt, z, a, u=u, dtype=bf16)
        u = u[..., :latent]
        diff_s = got_s != want_s
        n_diff_s = int(diff_s.sum())
        worst_s = float((u[diff_s] - p[diff_s]).abs().max()) if n_diff_s else 0.0
        excess = float((got_s - p).sum())
        sigma = float((p * (1 - p)).sum().sqrt())
        say(f"[check] B={b} transition{label} sample: {n_diff_s} bits differ "
            f"from the host Philox draw (largest |u-p| {worst_s:.3g}); "
            f"sum(s-p) = {excess:.1f}, binomial sd {sigma:.1f}")
        if n_diff_s and worst_s >= EPS_P:
            raise AssertionError("transition sample head disagrees")
        if abs(excess) > BINOMIAL_SIGMAS * max(sigma, 1.0):
            raise AssertionError("transition samples do not follow p")
    return {"t_err": t_err, "n_flips": n_flips, "n_bits": got.numel()}


def check_decoder(pd, z, label=""):
    """Hold the decoder kernel against its plain bf16 version."""
    bf16 = torch.bfloat16
    b = z.shape[0]
    with torch.inference_mode():
        got_d = fused_decode(pd, z).float()
        torch.cuda.synchronize()
        want_d = decode_plain(pd, z, dtype=bf16).float()
        d_err = float((got_d - want_d).abs().max())
        ok = bool(((got_d - want_d).abs()
                   <= DECODE_ATOL + DECODE_RTOL * want_d.abs()).all())
        say(f"[check] B={b} decoder{label}: max |kernel - plain| {d_err:.4g} "
            f"(limit {DECODE_ATOL} + {DECODE_RTOL}|plain|)")
        if not ok or not torch.isfinite(got_d).all():
            raise AssertionError("decoder kernel disagrees with its plain version")
    return d_err


def check_int8(name, packed, z, a, head):
    """Hold the int8 kernel against its plain version on int8 latents ``z``:
    every threshold bit equal, sampled bits equal wherever |u - p| >= EPS_U.
    Returns (differing threshold bits, bits compared)."""
    b = z.shape[0]
    seed = SEED % (1 << 31)
    with torch.inference_mode():
        got = i8.int8_transition(packed, z, a, head=head)
        torch.cuda.synchronize()
        want = i8.int8_transition_plain(packed, z, a, head=head)
        n_diff = int((got != want).sum())
        got_s = i8.int8_transition(packed, z, a, head="sample", seed=seed)
        u = host_uniforms(seed, (*z.shape[:3], packed["latent_pad"])).cuda()
        want_s = i8.int8_transition_plain(packed, z, a, head="sample", u=u)
        p = torch.sigmoid(i8.int8_transition_logits(packed, z, a))[..., :z.shape[-1]]
        diff_s = got_s != want_s
        n_diff_s = int(diff_s.sum())
        worst_s = float((u[..., :z.shape[-1]][diff_s] - p[diff_s]).abs().max()) \
            if n_diff_s else 0.0
    say(f"[check] B={b} {z.shape[1]}x{z.shape[2]} int8 {name} ({packed['order']}, hidden "
        f"{packed['hidden']}) {head} head: {n_diff} of {got.numel()} bits differ "
        f"(limit 0); sample head: {n_diff_s} differ from the host Philox draw "
        f"(largest |u-p| {worst_s:.3g}, limit {EPS_U})")
    if n_diff:
        raise AssertionError(f"int8 kernel ({name}) disagrees with its plain version")
    if n_diff_s and worst_s >= EPS_U:
        raise AssertionError(f"int8 kernel ({name}) sample head disagrees")
    return n_diff, got.numel()


def int8_cost(packed, z, a):
    """(operations, bytes) of one int8 step on the int8 latents ``z`` that
    the kernel takes: real channels only (no K or N padding); conv1's
    one-hot action channels are the per-sample bias the kernel adds
    (``b * actions * hidden`` products), not a conv."""
    if z.dtype != torch.int8:
        raise TypeError(f"int8_cost counts int8 latents; got {z.dtype}")
    b, h, w, latent = z.shape
    hid, acts = packed["hidden"], packed["num_actions"]
    ops = (2 * b * h * w * 9 * (latent * hid + 5 * hid * hid + 2 * hid * latent)
           + 2 * b * acts * hid)
    moved = nbytes(z, a, z, *i8._operand_tensors(packed))
    return ops, moved


def decode_cost(pd, z):
    """(FLOPs, bytes) of one decoder call on latents ``z`` (real channels:
    latent -> 4 latent -> colours)."""
    b, h, w, latent = z.shape
    hid, color = pd["w1"].shape[-1], pd["color"]
    flops = 2 * b * h * w * 9 * (latent * hid + hid * color)
    moved = nbytes(z, pd["w1"], pd["w2"], pd["b1"], pd["b2"]) + b * h * w * color * 2
    return flops, moved


def shape_key(latent, hidden):
    """A width row's key: the hidden width at latent 16, else both."""
    return hidden if latent == 16 else f"l{latent}-h{hidden}"


def transition_cost(pt, z, a):
    """(FLOPs, bytes) of one bf16 transition step (real channels; the action
    channels as conv1's per-sample bias, as in ``int8_cost``)."""
    b, h, w, latent = z.shape
    hid, acts = pt["w2"].shape[-1], a.shape[-1]
    flops = (2 * b * h * w * 9 * (latent * hid + 3 * hid * hid + 2 * hid * hid
                                  + 2 * hid * latent)
             + 2 * b * acts * hid)
    # latents in and out (in z's dtype), actions, weights and biases at the
    # model's width
    moved = (nbytes(z, a, z) + nbytes(*(pt[f"w{i}"] for i in range(1, 7)))
             + nbytes(*(pt[f"b{i}"][:pt[f"w{i}"].shape[-1]] for i in range(1, 7))))
    return flops, moved


# ---------------------------------------------------------------------------
# cuDNN yardsticks (timed only; the port never calls them)
# ---------------------------------------------------------------------------

def library_transition(packed, z, a):
    """The transition step as a chain of bf16 cuDNN convs (NCHW views of
    NHWC memory)."""
    b, h, w, latent = z.shape
    x = torch.cat([z, a[:, None, None, :].expand(b, h, w, a.shape[-1])], -1)
    x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    ws = {i: packed[f"w{i}"].reshape(3, 3, *packed[f"w{i}"].shape[1:])
          .permute(3, 2, 0, 1) for i in range(1, 7)}
    ws[1] = ws[1][:, :x.shape[1]]
    bs = {i: packed[f"b{i}"][:ws[i].shape[0]].to(torch.bfloat16) for i in range(1, 7)}

    def conv(i, inp):
        return F.conv2d(F.pad(inp, (1, 1, 1, 1), mode="circular"), ws[i], bs[i])

    h1 = F.leaky_relu(conv(1, x), 0.01)
    h2 = F.leaky_relu(conv(2, h1), 0.01)
    h3 = F.leaky_relu(conv(3, h2), 0.01)
    h4 = F.leaky_relu(conv(4, h3), 0.01)
    h5 = F.leaky_relu(conv(5, torch.cat([h4, h2], 1)), 0.01)
    p = torch.sigmoid(conv(6, torch.cat([h5, h1], 1)).float())
    return (p[:, :latent] > 0.5).permute(0, 2, 3, 1).to(z.dtype)


def library_decode(packed, z):
    """The fused decoder as two bf16 cuDNN convs."""
    x = z.to(torch.bfloat16).permute(0, 3, 1, 2)
    w1 = packed["w1"].reshape(3, 3, *packed["w1"].shape[1:]).permute(3, 2, 0, 1)
    w2 = packed["w2"].reshape(3, 3, *packed["w2"].shape[1:]).permute(3, 2, 0, 1)
    h1 = F.leaky_relu(F.conv2d(x, w1, packed["b1"].to(torch.bfloat16),
                               padding=1), 0.01)
    out = F.conv2d(h1, w2, packed["b2"].to(torch.bfloat16), padding=1)
    return out.permute(0, 2, 3, 1)


def profile_device(fn):
    """Run ``fn`` once under torch.profiler: (wall s, the card's busy s, device
    time by kernel name in µs).  Kernels run on one stream, so their times
    add up; the profiler itself lengthens the wall time."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time
    busy = sum(by_name.values()) * 1e-6
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")
    return wall, busy, by_name


# Kernel families of a profile, by a substring of the kernel's name (first
# match wins): the port's own kernels first, then the libraries'.
KERNEL_FAMILIES = (("the port's kernels", ("scm_tr::", "scm_i8::", "decode_kernel")),
                   ("conv (cuDNN)", ("fprop", "dgrad", "wgrad", "cudnn", "convolve")),
                   ("concatenation copies", ("CatArrayBatchedCopy",)),
                   ("reductions", ("reduce_kernel",)),
                   ("GEMM", ("gemm", "cutlass")),
                   ("elementwise", ("elementwise",)))


def print_top_kernels(tag, by_name, busy, n=8):
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]:
        say(f"[{tag}]   {us * 1e-3:9.2f} ms  {100 * us * 1e-6 / busy:5.1f}%  {name[:90]}")
    families = {}
    for name, us in by_name.items():
        family = next((f for f, keys in KERNEL_FAMILIES if any(k in name for k in keys)),
                      "other")
        families[family] = families.get(family, 0.0) + us
    say(f"[{tag}] by family: " + ", ".join(
        f"{f} {us * 1e-3:.2f} ms ({100 * us * 1e-6 / busy:.1f}%)"
        for f, us in sorted(families.items(), key=lambda kv: -kv[1])))


def profile_free_run(model, batch, num_actions, frames):
    """One free-run under torch.profiler: device time by kernel, and the
    card's busy share of the run's wall time."""
    def run():
        with torch.inference_mode():
            _free_run_stats(model, batch, num_actions)

    wall, busy, by_name = profile_device(run)
    say(f"[profile] free-run under the profiler: {wall:.3f} s wall, card busy "
        f"{busy:.3f} s ({100 * busy / wall:.1f}%), {frames / wall:.1f} frames/s")
    print_top_kernels("profile", by_name, busy)


def gate_in_f32(model, student, qt, batch, num_actions, latent, horizon=10):
    """The gate's MSE@t+``horizon`` on ``batch`` with every engine through
    the plain f32 transition and the plain f32 decoder (the JAX package's
    arithmetic), printed beside the record the bf16 kernels give.  The int8
    student's transition is exact either way."""
    f32 = torch.float32
    pd = pack_decoder_weights(model.decoder, latent, dtype=f32)
    decode = lambda z: decode_plain(pd, z)  # noqa: E731

    def mse(transition, transition_fn):
        m = model._replace(transition=transition)
        return float(_free_run_stats(m, batch, num_actions, transition_fn=transition_fn,
                                     decode_fn=decode)[0][horizon])

    with torch.inference_mode():
        out = {}
        for key, params in (("teacher", model.transition), ("student", student)):
            packed = pack_transition_weights(params, latent, num_actions, dtype=f32)
            out[key] = mse(params, lambda z, a, pt=packed: transition_plain(pt, z, a))
        out["int8"] = mse(student, lambda z, a: i8.int8_transition_plain(
            qt.packed, (z > 0.5).to(torch.int8), a).float())
    delta = lambda key: 100.0 * (out[key] - out["teacher"]) / out["teacher"]  # noqa: E731
    out["delta_pct"], out["int8_delta_pct"] = delta("student"), delta("int8")
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

class HostNoise(LossNoise):
    """``LossNoise`` drawn on the host from a seeded generator and moved to
    ``device``: the same numbers for a step on the card and on the CPU."""

    def __init__(self, seed: int, device):
        super().__init__(torch.Generator().manual_seed(seed))
        self.device = torch.device(device)

    def _uniform(self, shape, dtype):
        return super()._uniform(shape, dtype).to(self.device)

    def swap_indices(self, b, latent_dim):
        return tuple(i.to(self.device) for i in super().swap_indices(b, latent_dim))

    def permutation(self, b):
        return super().permutation(b).to(self.device)


def copy_params(params, device) -> WorldModel:
    """Detached copies of every parameter on ``device`` (leaf tensors, so a
    new optimizer can take them)."""
    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node.detach().to(device, copy=True)
    return WorldModel(*(walk(net) for net in params))


def flat_params(params) -> dict:
    """Every parameter of a WorldModel by its ``network/a/b`` path."""
    return dict(flatten_tree(params._asdict()))


def grad_norms(state) -> dict:
    """Each stepped network's gradient norm (after the value clip)."""
    out = {}
    for name, opt in state.optimizers.items():
        grads = [p.grad.double() for p in opt.param_groups[0]["params"]
                 if p.grad is not None]
        if grads:
            out[name] = float(torch.sqrt(sum((g * g).sum() for g in grads)))
    return out


def train_phase(ds, latent):
    """The third main path: ``trainer.train`` at full width on the card, then
    the checks of the training arithmetic.  Returns the kernels' launch
    counts of the ``train`` run and its mean ms per iteration by horizon."""
    num_actions = ds.binary_input_channels
    bf16 = torch.bfloat16
    cfg = Config(env=ENV, seed=SEED, train_iters=TRAIN_ITERS, iters_per_video=TRAIN_ITERS,
                 enable_disentanglement_loss=True, enable_action_control_loss=True,
                 counterfactual_horizon=2, eval_batch_size=BATCH,
                 eval_timesteps=TRAIN_EVAL_TIMESTEPS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = trainer.init_train_state(cfg, ds.spec, gen)
    n_params = sum(t.numel() for t in flat_params(state.params).values())
    say(f"[train] minipacman_cf width: latent {cfg.latent_dim}, hidden {cfg.hidden_dim}, "
        f"{ds.spec.height}x{ds.spec.width}x{ds.spec.channels} frames, {num_actions} actions, "
        f"{ds.spec.num_rewards} rewards; {n_params} parameters; B = {cfg.batch_size}, "
        f"{cfg.compute_dtype} compute, lr {cfg.learning_rate}, horizon "
        f"{cfg.horizon_min}->{cfg.horizon_max} over {cfg.train_iters} iterations, CF "
        f"every {cfg.cf_regularization_rate} (roll-out {cfg.counterfactual_horizon})")

    # 1-2. train(), with the evaluation hook before the last step
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    rows, hook, clock = [], {}, {}

    def eval_fn(st, it):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hook["result"] = measure_prediction_mse(
            st.params, ds, train_iter=it, batch_size=cfg.eval_batch_size,
            timesteps=cfg.eval_timesteps, out_dir=out_dir, make_plots=False,
            generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
        torch.cuda.synchronize()
        hook["s"] = time.perf_counter() - t0
        hook["iter"] = it
        hook["params"] = copy_params(st.params, "cuda")

    def log_fn(it, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append({"iter": it, "horizon": trainer.horizon_at(cfg, it),
                     "ms": 1e3 * (now - clock["t"]),
                     **{k: float(v) for k, v in metrics.items()}})
        clock["t"] = now

    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = clock["t"] = time.perf_counter()
    state = trainer.train(cfg, ds, state, eval_fn=eval_fn, log_fn=log_fn, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    rows[-1]["ms_without_eval"] = rows[-1]["ms"] - 1e3 * hook["s"]
    for r in rows:
        r["rec_per_step"] = r["reconstruction_loss"] / (r["horizon"] - 2)
        say(f"[train] iter {r['iter']:2d} horizon {r['horizon']:2d}: {r['ms']:9.2f} ms"
            + (f" ({r['ms_without_eval']:.2f} without the evaluation hook)"
               if "ms_without_eval" in r else "")
            + f"; loss {r['loss']:.6f}, reconstruction/step {r['rec_per_step']:.6f}, "
            f"reward {r['reward_loss']:.6f}, cf_disentanglement "
            f"{r['cf_disentanglement_loss']:.3e}, cf_control {r['cf_control_loss']:.3e}")
    by_h = {}
    for r in rows:
        by_h.setdefault(r["horizon"], []).append(r.get("ms_without_eval", r["ms"]))
    say("[train] mean ms per iteration by horizon (batch collection included; iteration "
        "1 includes first-call set-up): " + ", ".join(
            f"h{h} {np.mean(v):.2f} (n={len(v)})" for h, v in sorted(by_h.items())))
    say(f"[train] train() {train_s:.3f} s wall for {len(rows)} iterations; peak device "
        f"memory {peak / 2**30:.3f} GiB; evaluation hook at iteration {hook['iter']} "
        f"{hook['s']:.3f} s; launches {launches}")
    if launches != {"fused_transition": TRAIN_EVAL_TIMESTEPS - 1,
                    "fused_decode": TRAIN_EVAL_TIMESTEPS - 2, "int8_transition": 0}:
        raise AssertionError(f"the training path's evaluation did not run the kernels: "
                             f"{launches}")
    metric_keys = ("loss", "reward_loss", "reconstruction_loss", "cf_disentanglement_loss",
                   "cf_control_loss")
    if not np.isfinite([[r[k] for k in metric_keys] for r in rows]).all():
        raise AssertionError("a training loss is not finite")
    first = np.mean([r["rec_per_step"] for r in rows[:4]])
    last = np.mean([r["rec_per_step"] for r in rows[-4:]])
    say(f"[train] reconstruction loss per step: first 4 iterations {first:.6f}, last 4 "
        f"{last:.6f} ({100 * (last - first) / first:+.1f}%)")
    if not last < first:
        raise AssertionError("the reconstruction loss did not fall")

    # the evaluation hook's curve against the plain path on the same weights
    result = hook["result"]
    if result is None:
        raise AssertionError("degenerate evaluation batch")
    snap = hook["params"]
    with torch.inference_mode():
        batch = ds.collect(BATCH, TRAIN_EVAL_TIMESTEPS,
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
        short = tuple(x[:, :COMPARE_STEPS + 2] for x in batch)
        pt = pack_transition_weights(snap.transition, latent, num_actions)
        pd = pack_decoder_weights(snap.decoder, latent)
        plain = _free_run_stats(
            snap, short, num_actions,
            transition_fn=lambda z, a: transition_plain(pt, z, a, dtype=bf16),
            decode_fn=lambda z: decode_plain(pd, z, dtype=bf16))[0].cpu().numpy()
    main_curve = np.asarray(result[0][:COMPARE_STEPS])
    say(f"[train] evaluation pixel MSE, first {COMPARE_STEPS} steps: kernels "
        f"{np.array2string(main_curve, precision=6)}")
    say(f"[train]                                        plain   "
        f"{np.array2string(plain, precision=6)}")
    if not np.isfinite(np.asarray(result)).all():
        raise AssertionError("non-finite evaluation curves")
    if not np.allclose(main_curve, plain, rtol=CURVE_RTOL, atol=CURVE_ATOL):
        raise AssertionError("the evaluation hook's curve disagrees with the plain path")
    # A model this young may carry one constant latent in eval mode, which
    # would hold the curves equal whatever the kernels did: check both
    # kernels element by element on the trained weights, on random latents.
    rng = np.random.default_rng(SEED + 4)
    z, a = binary_latents(rng, BATCH), onehot_actions(rng, BATCH, num_actions)
    check_transition(pt, z, a, latent, " (trained weights)")
    check_decoder(pd, z, " (trained weights)")

    # 3. one f32 step on the card against the same step on the CPU
    cfg32 = cfg.replace(compute_dtype="float32", batch_size=2)
    h32 = 4
    batch = ds.collect(2, h32, generator=torch.Generator(device="cuda").manual_seed(SEED + 3))
    sides = {}
    for dev in ("cuda", "cpu"):
        params = copy_params(state.params, dev)
        st = trainer.TrainState(params, trainer.make_optimizer(cfg32, params), 1)
        t0 = time.perf_counter()
        st, m = trainer.make_train_step(cfg32, h32)(
            st, tuple(x.to(dev) for x in batch), HostNoise(SEED, dev), 0.5, 1.0)
        if dev == "cuda":
            torch.cuda.synchronize()
        sides[dev] = ({k: float(v) for k, v in m.items()}, grad_norms(st),
                      {k: v.detach().cpu() for k, v in flat_params(st.params).items()},
                      time.perf_counter() - t0)
    (m_c, g_c, p_c, s_c), (m_h, g_h, p_h, s_h) = sides["cuda"], sides["cpu"]
    diffs = {k: (p_c[k] - p_h[k]).abs() for k in p_c}
    worst = max(float(d.max()) for d in diffs.values())
    n_apart = sum(int((d > TRAIN_PARAM_ATOL).sum()) for d in diffs.values())
    n_total = sum(d.numel() for d in diffs.values())
    say(f"[train] f32 step B=2 horizon {h32} (TF32 off), card / CPU: " + ", ".join(
        f"{k} {m_c[k]:.7g} / {m_h[k]:.7g}" for k in sorted(m_c)))
    say("[train]   gradient norms card / CPU: " + ", ".join(
        f"{k} {g_c[k]:.7g} / {g_h[k]:.7g}" for k in sorted(g_c))
        + f"; parameters after Adam and the SN refresh: {n_apart} of {n_total} more than "
        f"{TRAIN_PARAM_ATOL} apart, largest {worst:.3g} (limit 2 lr + {TRAIN_PARAM_ATOL}); "
        f"step {1e3 * s_c:.1f} ms on the card, {1e3 * s_h:.1f} ms on the CPU")
    for k in m_h:
        if not np.isclose(m_c[k], m_h[k], rtol=TRAIN_LOSS_RTOL, atol=0):
            raise AssertionError(f"f32 step: {k} differs between the card and the CPU")
    for k in g_h:
        if not np.isclose(g_c[k], g_h[k], rtol=TRAIN_GRAD_NORM_RTOL, atol=0):
            raise AssertionError(f"f32 step: {k} gradient differs between card and CPU")
    if (worst > 2 * cfg32.learning_rate + TRAIN_PARAM_ATOL
            or n_apart > TRAIN_SIGN_FLIP_FRACTION * n_total):
        raise AssertionError("f32 step: updated parameters differ between card and CPU")

    # 4. overshooting and TD(lambda) at horizon 10, B = 32: the slot buffer
    # advances as one S * B batch per step
    extra = {}
    for flag in ("latent_overshooting", "latent_td"):
        c = cfg.replace(**{flag: True})
        step = trainer.make_train_step(c, c.horizon_max)
        batch = ds.collect(c.batch_size, c.horizon_max, generator=gen)
        times = []
        for _ in range(2):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch, LossNoise(gen), 1.0, 0.0)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        extra[flag] = {"ms": times, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "lo_loss": float(m["lo_loss"]), "loss": float(m["loss"])}
        say(f"[train] {flag} step, horizon {c.horizon_max}, B = {c.batch_size} (slot "
            f"buffer {c.batch_size} x {c.horizon_max if flag == 'latent_overshooting' else c.td_steps + 2}): "
            f"{times[0]:.2f} ms first, {times[1]:.2f} ms second; peak device memory "
            f"{extra[flag]['peak_gib']:.3f} GiB; loss {m['loss']:.6f}, lo_loss "
            f"{m['lo_loss']:.6f}")
        if not np.isfinite([extra[flag]["loss"], extra[flag]["lo_loss"]]).all():
            raise AssertionError(f"{flag}: loss not finite")

    # 5. save / load round trip of the trained bundle
    bundle = tempfile.mkdtemp(prefix="chip_smoke_bundle_")
    save_model(bundle, state.params)
    back = flat_params(load_model(bundle, device="cuda"))
    mine = flat_params(state.params)
    if sorted(back) != sorted(mine) or not all(
            back[k].dtype == v.dtype and torch.equal(back[k], v) for k, v in mine.items()):
        raise AssertionError("save_model / load_model round trip is not bit-equal")
    say(f"[train] save_model / load_model round trip: {len(mine)} arrays bit-equal")

    # 6. one iteration's step at horizon 10 under the profiler
    step = trainer.make_train_step(cfg, cfg.horizon_max)
    batch = ds.collect(cfg.batch_size, cfg.horizon_max, generator=gen)
    holder = {"state": step(state, batch, LossNoise(gen), 1.0, 1.0)[0]}

    def one_step():
        holder["state"] = step(holder["state"], batch, LossNoise(gen), 1.0, 1.0)[0]

    wall, busy, by_name = profile_device(one_step)
    say(f"[train] one step at horizon {cfg.horizon_max}, B = {cfg.batch_size}, CF on, "
        f"under the profiler: {1e3 * wall:.2f} ms wall, card busy {1e3 * busy:.2f} ms "
        f"({100 * busy / wall:.1f}%), {len(by_name)} kernel names")
    print_top_kernels("train", by_name, busy, n=12)
    return launches, {h: float(np.mean(v)) for h, v in by_h.items()}


# ---------------------------------------------------------------------------
# MPC: the planner and the play loops through the transition kernels
# ---------------------------------------------------------------------------

MPC_GRID = "pretrained_models/gridworld_cf"
MPC_PONG = "pretrained_models/pong_cf_60k"
MPC_RECORDS = {"gridworld": "docs/mpc_sweep_gridworld.json",
               "pong60k": "docs/mpc_sweep_pong60k.json",
               "pong": "docs/mpc_sweep_pong.json"}
MPC_LOOKAHEAD, MPC_DEPTH, MPC_STEPS = 2, 12, 300    # the records' reference beam
MPC_GRID_EPISODES = 10
MPC_GRID_FLOOR = 280.0       # the record: +291.7 +- 0.94 (n = 10); random +0.07 +- 8.0
MPC_PONG_SECONDS = 60.0      # pong_cf_60k episodes: as many as fit in about this
MPC_PONG_MAX_EPISODES = 20
MPC_AGREEMENT_STATES = 50
MPC_HOST_STEPS = 50
# 16x16 kernel checks: a head stage (B = 4), one episode's beam (64) and the
# beam of the gridworld episodes together (10 x 64).
MPC_CHECK_BATCHES = (4, 64, MPC_GRID_EPISODES * 64)
MPC_TIME_SHAPES = ((16, 4), (16, 64), (16, MPC_GRID_EPISODES * 64), (64, 4), (64, 64))


def mean_se(xs):
    xs = np.asarray(xs, np.float64)
    se = xs.std(ddof=1) / np.sqrt(len(xs)) if len(xs) > 1 else float("nan")
    return float(xs.mean()), float(se)


def play_launches(chunks: int, max_steps: int, lookahead: int, depth: int) -> int:
    """bf16 transition calls of ``play_on_device`` with the exact beam: per
    chunk the first window step, then per env step the head's lookahead + 1
    stages, the tail's depth - lookahead steps and the window step."""
    return chunks * (1 + (max_steps - 1) * (lookahead + 1 + depth - lookahead + 1))


def seed_latents(model, ds, n, seed):
    """n latent states as play makes them: three frames of an episode
    encoded, then one exact transition under the no-op."""
    obs, _, _, _ = ds.collect(n, 3, generator=torch.Generator(device=ds.device).manual_seed(seed))
    a = F.one_hot(torch.full((n,), 3 % ds.binary_input_channels, device=ds.device),
                  ds.binary_input_channels).float()
    latent = model.transition["conv6"]["w"].shape[-1]
    pt = pack_transition_weights(model.transition, latent, ds.binary_input_channels)
    with torch.inference_mode():
        return fused_transition(pt, encode(model.encoder, obs), a)


def mpc_kernel_checks(model, qt, rng):
    """(a) both transition kernels at 16x16 against their plain versions."""
    pt = pack_transition_weights(model.transition, 16, 4)
    static = quantize_transition(model.transition).packed
    checks, int8_checks = [], []
    for b in MPC_CHECK_BATCHES:
        z, a = binary_latents(rng, b, 16), onehot_actions(rng, b, 4)
        checks.append(check_transition(pt, z, a, 16, " (gridworld_cf, 16x16)"))
        int8_checks.append(check_int8("gridworld_cf calibrated", qt.packed,
                                      z.to(torch.int8), a, "logit"))
        int8_checks.append(check_int8("gridworld_cf static", static, z.to(torch.int8), a,
                                      "logit"))
    return checks, int8_checks


def mpc_times(models, qts):
    """Per-call ms of both transition kernels at the MPC shapes, beside the
    plain versions, cuDNN's chain and the bound."""
    rng = np.random.default_rng(SEED + 7)
    rows = {}
    with torch.inference_mode():
        for hw, b in MPC_TIME_SHAPES:
            model, qt = models[hw], qts[hw]
            pt = pack_transition_weights(model.transition, 16, 4)
            z, a = binary_latents(rng, b, hw), onehot_actions(rng, b, 4)
            zi = z.to(torch.int8)
            key = f"{hw}x{hw} B={b}"
            rows[key] = {
                "ms": cuda_ms(lambda: fused_transition(pt, z, a)),
                "plain_ms": cuda_ms(lambda: transition_plain(pt, z, a, dtype=torch.bfloat16),
                                    iters=5),
                "library_ms": cuda_ms(lambda: library_transition(pt, z, a)),
                "bound": bound(*transition_cost(pt, z, a)),
                "int8_ms": cuda_ms(lambda: i8.int8_transition(qt.packed, zi, a, head="logit")),
                "int8_plain_ms": cuda_ms(lambda: i8.int8_transition_plain(
                    qt.packed, zi, a, head="logit"), iters=3),
                "int8_bound": bound(*int8_cost(qt.packed, zi, a), peak=PEAK_INT8_OPS)}
            r = rows[key]
            say(f"[mpc-time] {key}: bf16 kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, "
                f"cuDNN {r['library_ms']:.4f}, bound {r['bound'][0]:.4f} ({r['bound'][1]}); "
                f"int8 kernel {r['int8_ms']:.4f} ms, plain {r['int8_plain_ms']:.4f}, bound "
                f"{r['int8_bound'][0]:.4f} ({r['int8_bound'][1]})")
    return rows


def mpc_phase():
    """The MPC path: the planner and play loops at full width (hidden 128)
    through the transition kernels.  Returns the launch counts of its runs."""
    with open(MPC_RECORDS["gridworld"]) as f:
        grid_rec = json.load(f)["arms"]
    with open(MPC_RECORDS["pong60k"]) as f:
        pong_rec = json.load(f)["arms"]["ref"]
    with open(MPC_RECORDS["pong"]) as f:
        pong_random = json.load(f)["arms"]["random"]
    grid = load_model(MPC_GRID, device="cuda")
    pong = load_model(MPC_PONG, device="cuda")
    grid_ds = allocate_datasource("gridworld", seed=SEED, device="cuda")
    pong_ds = allocate_datasource("pong", seed=SEED, device="cuda")
    z_grid = seed_latents(grid, grid_ds, 1, SEED + 20)
    z_pong = seed_latents(pong, pong_ds, 1, SEED + 21)
    qt_grid = calibrated_qt(grid, z_grid, 4)
    qt_pong = calibrated_qt(pong, z_pong, 4)
    beam = dict(lookahead=MPC_LOOKAHEAD, rollout_depth=MPC_DEPTH)
    launches = {}
    say(f"[mpc] gridworld_cf and pong_cf_60k: latent 16, hidden "
        f"{grid.transition['conv2']['w'].shape[-1]} / {pong.transition['conv2']['w'].shape[-1]}, "
        f"4 actions, 16x16 and 64x64 frames; beam 4^{MPC_LOOKAHEAD + 1} = "
        f"{4 ** (MPC_LOOKAHEAD + 1)} plans x {MPC_DEPTH + 1} steps")

    # (a) the kernels at 16x16
    checks, int8_checks = mpc_kernel_checks(grid, qt_grid, np.random.default_rng(SEED + 5))

    # (b, c) gridworld_cf, the reference beam, 10 episodes x 300 steps
    chunk = _episode_chunk(grid_ds.spec, 128, 4, MPC_LOOKAHEAD, "noop", 1, grid_ds.device)
    chunks = -(-MPC_GRID_EPISODES // (chunk or MPC_GRID_EPISODES))
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rewards, steps = play_on_device(grid, grid_ds, episodes=MPC_GRID_EPISODES,
                                    max_steps=MPC_STEPS, seed0=SEED, verbose=False, **beam)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    launches["mpc_gridworld"] = counters()
    implied = play_launches(chunks, MPC_STEPS, MPC_LOOKAHEAD, MPC_DEPTH)
    mean, se = mean_se(rewards)
    say(f"[mpc] gridworld_cf play_on_device, {MPC_GRID_EPISODES} episodes x {MPC_STEPS} "
        f"steps (lookahead {MPC_LOOKAHEAD}, depth {MPC_DEPTH}, beam B = "
        f"{MPC_GRID_EPISODES} x 64 in {chunks} chunk(s)): {grid_s:.3f} s wall, "
        f"{1e3 * grid_s / (MPC_STEPS - 1):.3f} ms per env step of all episodes")
    say(f"[mpc] gridworld_cf episode scores {rewards}, steps {sorted(set(steps))}")
    say(f"[mpc] gridworld_cf mean {mean:+.2f} +- {se:.2f} (SE, n = {len(rewards)}); record "
        f"(JAX package) {grid_rec['ref']['mean']:+.2f} +- {grid_rec['ref']['stderr']:.2f} "
        f"(n = {grid_rec['ref']['n']}), random {grid_rec['random']['mean']:+.2f} +- "
        f"{grid_rec['random']['stderr']:.2f}; limit >= {MPC_GRID_FLOOR}")
    say(f"[mpc] launches {launches['mpc_gridworld']}; the loop implies {implied} bf16 "
        f"transition calls")
    if launches["mpc_gridworld"] != {"fused_transition": implied, "fused_decode": 0,
                                     "int8_transition": 0}:
        raise AssertionError("the MPC path did not run on the bf16 kernel alone")
    if not mean >= MPC_GRID_FLOOR or steps != [MPC_STEPS + 1] * MPC_GRID_EPISODES:
        raise AssertionError("gridworld MPC scores below the record's range")

    # (d) the oracle on gridworld
    t0 = time.perf_counter()
    oracle, _ = play_oracle_on_device(grid_ds.spec, episodes=MPC_GRID_EPISODES,
                                      max_steps=MPC_STEPS, seed0=SEED, verbose=False,
                                      device=grid_ds.device, **beam)
    o_mean, o_se = mean_se(oracle)
    say(f"[mpc] gridworld oracle (true dynamics, same beam): {oracle}; mean {o_mean:+.2f} +- "
        f"{o_se:.2f}; record {grid_rec['oracle_ref']['mean']:+.2f} +- "
        f"{grid_rec['oracle_ref']['stderr']:.2f}; {time.perf_counter() - t0:.3f} s")
    if not np.isfinite(oracle).all() or o_mean < mean - 5 * max(se, 1.0):
        raise AssertionError("the oracle plans worse than the model")

    # (f) ms per plan on pong_cf_60k: bf16 kernel, int8 kernel, plain f32
    planners = {
        "bf16 kernel": make_planner(pong, 4, **beam),
        "int8 kernel (calibrated_qt)": make_planner(pong, 4, use_int8=True, qt=qt_pong, **beam),
        "plain f32": make_planner(pong, 4, dtype=torch.float32, **beam)}
    plan_ms = {name: cuda_ms(lambda p=p: p(z_pong), iters=3 if "plain" in name else 10)
               for name, p in planners.items()}
    say("[mpc] pong_cf_60k ms per plan (one state, beam 64 x 13 steps): " + ", ".join(
        f"{k} {v:.3f}" for k, v in plan_ms.items()))
    zs = seed_latents(pong, pong_ds, MPC_AGREEMENT_STATES, SEED + 22)
    steps_by = {k: plan_steps(pong, 4, dtype=torch.float32 if "plain" in k else torch.bfloat16,
                              qt=qt_pong if "int8" in k else None) for k in planners}
    scores = {}
    for k, st in steps_by.items():
        scores[k] = torch.cat([rollout_reward_table(
            pong, zs[i:i + 10], 4, **beam, use_int8="int8" in k, steps=st)
            for i in range(0, MPC_AGREEMENT_STATES, 10)]).cpu().numpy()
    ref = scores["plain f32"]
    top2 = np.sort(ref, axis=1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    for k in ("bf16 kernel", "int8 kernel (calibrated_qt)"):
        agree = scores[k].argmax(1) == ref.argmax(1)
        say(f"[mpc] argmax agreement, {k} vs plain f32 over {MPC_AGREEMENT_STATES} pong "
            f"states: {int(agree.sum())}/{MPC_AGREEMENT_STATES}; where plain's top two are "
            f"more than 0.1 apart: {int(agree[gap > 0.1].sum())}/{int((gap > 0.1).sum())}; "
            f"max |score - plain| {np.abs(scores[k] - ref).max():.4g}")
    if not all(np.isfinite(s).all() for s in scores.values()):
        raise AssertionError("non-finite plan scores")
    wall, busy, by_name = profile_device(lambda: planners["bf16 kernel"](z_pong))
    say(f"[mpc] one bf16 plan under the profiler: {1e3 * wall:.3f} ms wall, card busy "
        f"{1e3 * busy:.3f} ms ({100 * busy / wall:.1f}%)")
    print_top_kernels("mpc", by_name, busy)

    # (e) pong_cf_60k episodes, as many as fit in about MPC_PONG_SECONDS
    n_pong = int(max(1, min(MPC_PONG_MAX_EPISODES,
                            MPC_PONG_SECONDS / (MPC_STEPS * plan_ms["bf16 kernel"] * 1e-3))))
    chunk = _episode_chunk(pong_ds.spec, 128, 4, MPC_LOOKAHEAD, "noop", 1, pong_ds.device)
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_rewards, p_steps = play_on_device(pong, pong_ds, episodes=n_pong, max_steps=MPC_STEPS,
                                        seed0=SEED, verbose=False, **beam)
    torch.cuda.synchronize()
    pong_s = time.perf_counter() - t0
    launches["mpc_pong"] = counters()
    p_mean, p_se = mean_se(p_rewards)
    say(f"[mpc] pong_cf_60k play_on_device, {n_pong} episodes x {MPC_STEPS} steps: "
        f"{pong_s:.3f} s wall ({1e3 * pong_s / (MPC_STEPS - 1):.3f} ms per env step of all "
        f"episodes); scores {p_rewards}; mean {p_mean:+.2f} +- {p_se:.2f} (SE, n = {n_pong}); "
        f"record {pong_rec['mean']:+.2f} +- {pong_rec['stderr']:.2f} (n = {pong_rec['n']}), "
        f"random (pong_cf record) {pong_random['mean']:+.2f} +- {pong_random['stderr']:.2f}; "
        f"launches {launches['mpc_pong']}")
    implied = play_launches(-(-n_pong // (chunk or n_pong)), MPC_STEPS, MPC_LOOKAHEAD,
                            MPC_DEPTH)
    if (launches["mpc_pong"]["fused_transition"] != implied
            or not np.isfinite(p_rewards).all() or p_steps != [MPC_STEPS + 1] * n_pong):
        raise AssertionError("the pong MPC run did not complete on the kernel")

    # (g) one sampled plan (the Bernoulli head), one host episode on the int8 beam
    sampler = make_planner(pong, 4, rollout_samples=4,
                           generator=torch.Generator(device=pong_ds.device).manual_seed(SEED),
                           **beam)
    zero_counters()
    action, s_scores = sampler(z_pong)
    launches["mpc_sampled_plan"] = counters()
    say(f"[mpc] rollout_samples=4 plan on pong_cf_60k: action {action}, scores "
        f"{np.array2string(s_scores.cpu().numpy(), precision=4)}; launches "
        f"{launches['mpc_sampled_plan']} (3 head stages exact, 10 tail steps sampled)")
    if (launches["mpc_sampled_plan"]["fused_transition"] != MPC_DEPTH + 1
            or not torch.isfinite(s_scores).all()):
        raise AssertionError("the sampled plan did not run on the kernel")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_play_")
    zero_counters()
    t0 = time.perf_counter()
    h_reward, h_t = play(grid, grid_ds, max_steps=MPC_HOST_STEPS, out_dir=out_dir,
                         verbose=False, seed=SEED, use_int8=True, write_video=True, **beam)
    host_s = time.perf_counter() - t0
    launches["mpc_host_play_int8"] = counters()
    written = sorted(os.listdir(out_dir))
    say(f"[mpc] host play, gridworld_cf, int8 beam (calibrated_qt), {MPC_HOST_STEPS} steps: "
        f"reward {h_reward}, t={h_t}, {host_s:.3f} s; launches "
        f"{launches['mpc_host_play_int8']}; wrote {written}")
    if (launches["mpc_host_play_int8"] != {
            "fused_transition": MPC_HOST_STEPS, "fused_decode": 0,
            "int8_transition": (MPC_HOST_STEPS - 1) * (MPC_DEPTH + 1)}
            or not any(w.startswith("evaluation_metrics_") for w in written)):
        raise AssertionError("the host play episode did not run on the kernels")

    times = mpc_times({16: grid, 64: pong}, {16: qt_grid, 64: qt_pong})
    return {"launches": launches, "checks": checks, "int8_checks": int8_checks,
            "times": times, "plan_ms": plan_ms,
            "scores": {"gridworld": rewards, "oracle": oracle, "pong60k": p_rewards}}


# ---------------------------------------------------------------------------
# the command line: python -m scmgan_tpu_torch, driven in this process
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
CLI_TRAIN_ITERS, CLI_ITERS_PER_VIDEO = 12, 10
# The evaluation's videos (analysis/evaluate.py), by name.
VIDEO_PREFIXES = ("simulation_ftr_", "prediction_", "reward_prediction_")
CLI_GRID_EPISODES = 3
HIGGINS_RECORD = "docs/higgins_zoo.json"
REFERENCE_BUNDLE = "pretrained_models/reference_ab_gridworld"


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block: the
    command line looks its callees up at call time, so a recorder sees
    them."""
    original = getattr(owner, name)
    setattr(owner, name, wrap(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def cli_config(argv):
    return cli.config_from_args(cli.build_parser().parse_args(argv))


def evaluate_launches(cfg, videos: bool) -> dict:
    """Kernel calls of one ``evaluate``: the free-run (T - 1 transitions,
    T - 2 decodes), and with videos the forward simulation (one transition
    then one of each a step, T_sim - 3 steps) and one batched rollout a
    reconstruction offset (1 + offset transitions, one decode)."""
    t = cfg.eval_timesteps
    n_t, n_d = t - 1, t - 2
    if videos:
        t_sim = inspect.signature(visualize.visualize_forward_simulation).parameters[
            "timesteps"].default
        offsets = inspect.signature(visualize.visualize_reconstruction).parameters[
            "offsets"].default
        n_t += 1 + (t_sim - 3) + sum(1 + o for o in offsets)
        n_d += (t_sim - 3) + len(offsets)
    return {"fused_transition": n_t, "fused_decode": n_d, "int8_transition": 0}


def play_kernel_launches(cfg, episodes: int, int8: bool) -> dict:
    """Kernel calls of ``episodes`` host ``play`` episodes that run to the
    step limit: the window steps on the bf16 kernel, the beam on the bf16
    or the int8 kernel."""
    steps, look, depth = cfg.mpc_max_steps, cfg.mpc_lookahead, cfg.mpc_rollout_depth
    if int8:
        return {"fused_transition": episodes * steps, "fused_decode": 0,
                "int8_transition": episodes * (steps - 1) * (depth + 1)}
    return {"fused_transition": episodes * play_launches(1, steps, look, depth),
            "fused_decode": 0, "int8_transition": 0}


def add_launches(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def train_snapshot(state) -> dict:
    """Host copies of a TrainState: parameters, each parameter's Adam
    moments and step, and the state's step."""
    adam = {}
    for name, opt in state.optimizers.items():
        for path, leaf in flatten_tree(getattr(state.params, name)):
            st = opt.state.get(leaf)
            if st:
                adam[f"{name}/{path}"] = (st["exp_avg"].cpu().clone(),
                                          st["exp_avg_sq"].cpu().clone(), float(st["step"]))
    return {"params": {k: v.detach().cpu().clone() for k, v in flat_params(state.params).items()},
            "adam": adam, "step": state.step}


def run_cli(label, argv):
    """``cli.main(argv)`` with the launch counters read around it and its
    console output (a line per play step) kept aside, its tail printed on a
    failure; returns (results, launches, wall seconds)."""
    zero_counters()
    torch.cuda.synchronize()
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            res = cli.main(argv)
    except BaseException:
        say(out.getvalue()[-4000:])
        raise
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    say(f"[cli] ({label}) python -m scmgan_tpu_torch {' '.join(argv)}: {wall:.3f} s wall; "
        f"launches {launches}; {len(out.getvalue().splitlines())} lines of output")
    return res, launches, wall


def check_launches(label, got, want):
    if got != want:
        raise AssertionError(f"cli ({label}): launches {got}, the run implies {want}")


def print_curve(label, curve, record_path):
    with open(record_path) as f:
        record = json.load(f)
    n = min(10, len(curve), len(record))
    say(f"[cli] ({label}) pixel MSE, first {n} steps: port   "
        f"{np.array2string(np.asarray(curve[:n]), precision=5)}; mean over "
        f"{len(curve)} steps {np.mean(curve):.6g}")
    say(f"[cli] ({label})                       record "
        f"{np.array2string(np.asarray(record[:n]), precision=5)}; mean over "
        f"{len(record)} steps {np.mean(record):.6g} ({record_path})")


def cli_kernel_checks():
    """Each kernel against its plain version at every shape the command
    line's runs give it: the evaluation's free-run at the eval batch, the
    forward simulation at B = 1 and the reconstruction windows at
    B = T - 3 - offset, on gridworld's 16x16 and minipacman's 64x64 frames
    (teacher and h48 student); play's window step at B = 1 and its beam
    stages at B = 4^k; the ``.pth`` bundle; the subprocess run's B = 8;
    int8 play's beam on pong_cf_60k.  Returns (transition checks, decoder
    max errors, int8 checks)."""
    rng = np.random.default_rng(SEED + 9)
    params = inspect.signature(visualize.visualize_reconstruction).parameters
    t_viz, offsets = params["timesteps"].default, params["offsets"].default
    viz = (1, *(t_viz - 3 - o for o in offsets))
    cfg = cli_config(["--env", "gridworld"])
    beam = tuple(4 ** k for k in range(1, cfg.mpc_lookahead + 2))
    grid_b = sorted({*viz, *beam, 8, cfg.eval_batch_size})
    pth_b = sorted({1, *beam, cfg.eval_batch_size})
    grid, pth = load_model(MPC_GRID, device="cuda"), load_model(REFERENCE_BUNDLE, device="cuda")
    pacman, pong = load_model(BUNDLE, device="cuda"), load_model(MPC_PONG, device="cuda")
    h48 = load_pytree(f"{STUDENT}/model-transition.npz", "cuda")
    pacman_a = pacman.transition["conv1"]["w"].shape[2] - 16
    transitions = [   # (label, packing, actions, hw, batches)
        ("gridworld_cf", pack_transition_weights(grid.transition, 16, 4), 4, 16, grid_b),
        ("reference_ab_gridworld", pack_transition_weights(pth.transition, 16, 4), 4, 16,
         pth_b),
        ("minipacman_cf", pack_transition_weights(pacman.transition, 16, pacman_a),
         pacman_a, 64, viz),
        ("h48 student", pack_transition_weights(h48, 16, pacman_a), pacman_a, 64, viz),
        ("pong_cf_60k", pack_transition_weights(pong.transition, 16, 4), 4, 64, (1,)),
    ]
    decoders = [   # (label, packing, hw, batches)
        ("gridworld_cf", pack_decoder_weights(grid.decoder, 16), 16,
         sorted({*viz, 8, cfg.eval_batch_size})),
        ("reference_ab_gridworld", pack_decoder_weights(pth.decoder, 16), 16,
         (cfg.eval_batch_size,)),
        ("minipacman_cf", pack_decoder_weights(pacman.decoder, 16), 64, viz),
    ]
    checks, d_errs, int8_checks = [], [], []
    for label, packed, acts, hw, batches in transitions:
        for b in batches:
            z, a = binary_latents(rng, b, hw), onehot_actions(rng, b, acts)
            checks.append(check_transition(packed, z, a, 16, f" ({label}, {hw}x{hw})"))
    for label, packed, hw, batches in decoders:
        for b in batches:
            d_errs.append(check_decoder(packed, binary_latents(rng, b, hw),
                                        f" ({label}, {hw}x{hw})"))
    qt = quantize_transition(pong.transition).packed
    for b in beam:
        z, a = binary_latents(rng, b, 64), onehot_actions(rng, b, 4)
        int8_checks.append(check_int8("pong_cf_60k static", qt, z.to(torch.int8), a,
                                      "logit"))
    return checks, d_errs, int8_checks


def cli_phase():
    """The command line on the card, in this process: train, resume, the
    full evaluation, int8 play, the student, a ``.pth`` bundle; then one
    ``python -m scmgan_tpu_torch`` subprocess.  Returns the kernels' launch
    counts summed over the runs, each run's wall seconds and the kernel
    checks at the runs' shapes."""
    checks, d_errs, int8_checks = cli_kernel_checks()
    totals, walls = [], {}
    seed = ["--seed", str(SEED)]

    # (a) train minipacman at the Config's full width, B = 32
    train_dir = tempfile.mkdtemp(prefix="chip_smoke_cli_train_")
    argv = ["--env", ENV, "--train-iters", str(CLI_TRAIN_ITERS), "--iters-per-video",
            str(CLI_ITERS_PER_VIDEO), "--eval-batch-size", str(BATCH),
            "--eval-timesteps", str(TRAIN_EVAL_TIMESTEPS), *seed, "--out-dir", train_dir]
    cfg = cli_config(argv)
    metrics, saved = [], []

    def recording_train(train):
        def run(cfg, datasource, state, *, log_fn, **kw):
            def log(i, m):
                metrics.append((i, m))
                log_fn(i, m)
            return train(cfg, datasource, state, log_fn=log, **kw)
        return run

    def recording_save(save):
        def run(ckpt_dir, state):
            saved.append(train_snapshot(state))
            return save(ckpt_dir, state)
        return run

    with patched(trainer, "train", recording_train), \
            patched(ckpt, "save_train_state", recording_save):
        res, launches, walls["train"] = run_cli("a: train", argv)
    totals.append(launches)
    losses = np.array([[float(v) for v in m.values()] for _, m in metrics])
    say(f"[cli] (a) minipacman, hidden {cfg.hidden_dim}, B = {cfg.batch_size}: "
        f"{len(metrics)} iterations, loss first {float(metrics[0][1]['loss']):.6f} last "
        f"{float(metrics[-1][1]['loss']):.6f}; {len(saved)} checkpoint(s), step "
        f"{[s['step'] for s in saved]}")
    n_evals = sum(1 for i in range(cfg.start_iter, cfg.train_iters + 1)
                  if i % cfg.iters_per_video == 0)
    check_launches("a", launches, {k: n_evals * v for k, v in
                                   evaluate_launches(cfg, videos=True).items()})
    if len(metrics) != cfg.train_iters or not np.isfinite(losses).all():
        raise AssertionError("cli (a): a training loss is not finite")
    written = sorted(os.listdir(train_dir))
    it = f"iter_{CLI_ITERS_PER_VIDEO:06d}"
    wanted = [*ckpt.MODEL_FILES.values(), ckpt.OPT_FILE, ckpt.STEP_FILE,
              *(f"mse_{k}_{it}.json" for k in ("pixel", "reward", "stddev_pixel",
                                                "stddev_reward")),
              f"simulation_ftr_{it}", f"prediction_01_{it}", f"prediction_03_{it}",
              f"reward_prediction_01_{it}", f"reward_prediction_03_{it}"]
    missing = [w for w in wanted if not any(f.startswith(w) for f in written)]
    say(f"[cli] (a) wrote {written}")
    videos = [f for f in written if f.startswith(VIDEO_PREFIXES)]
    if missing or len(saved) != n_evals:
        raise AssertionError(f"cli (a): missing artifacts {missing}")

    # (b) resume from that directory: what is loaded is what was saved
    loaded = []

    def recording_load(load):
        def run(ckpt_dir, template):
            state = load(ckpt_dir, template)
            loaded.append(train_snapshot(state))
            return state
        return run

    argv = ["--env", ENV, "--load-from", train_dir, "--start-iter",
            str(CLI_TRAIN_ITERS - 1), "--train-iters", str(CLI_TRAIN_ITERS + 1), *seed,
            "--iters-per-video", str(CLI_ITERS_PER_VIDEO),
            "--out-dir", tempfile.mkdtemp(prefix="chip_smoke_cli_resume_")]
    metrics.clear()
    with patched(trainer, "train", recording_train), \
            patched(ckpt, "load_train_state", recording_load):
        res, launches, walls["resume"] = run_cli("b: resume", argv)
    totals.append(launches)
    want, got = saved[-1], loaded[0]
    equal = (sorted(want["params"]) == sorted(got["params"])
             and all(torch.equal(v, got["params"][k]) for k, v in want["params"].items()))
    adam_equal = (sorted(want["adam"]) == sorted(got["adam"]) and all(
        torch.equal(m, got["adam"][k][0]) and torch.equal(v, got["adam"][k][1])
        and got["adam"][k][2] == s for k, (m, v, s) in want["adam"].items()))
    say(f"[cli] (b) loaded {len(got['params'])} arrays, {len(got['adam'])} parameters' Adam "
        f"moments and steps, step {got['step']} (saved {want['step']}): bit-equal "
        f"{equal and adam_equal}; then {len(metrics)} iterations, final step "
        f"{res['state'].step}")
    if not (equal and adam_equal and got["step"] == want["step"]):
        raise AssertionError("cli (b): the resumed state is not bit-equal to the saved one")
    if (len(metrics) != 3 or res["state"].step != want["step"] + 3
            or not np.isfinite([[float(v) for v in m.values()] for _, m in metrics]).all()):
        raise AssertionError("cli (b): the resumed run did not train")
    check_launches("b", launches, {k: 0 for k in launches})

    # (c) the full evaluation on gridworld_cf
    argv = ["--env", "gridworld", "--evaluate", "--load-from", MPC_GRID, "--evaluations",
            str(CLI_GRID_EPISODES), "--causal-graph", "--higgins", *seed,
            "--out-dir", tempfile.mkdtemp(prefix="chip_smoke_cli_eval_")]
    cfg = cli_config(argv)
    res, launches, walls["evaluate"] = run_cli("c: evaluate", argv)
    totals.append(launches)
    scores = [r for r, _ in res["scores"]]
    mean, se = mean_se(scores)
    say(f"[cli] (c) gridworld_cf play x{len(scores)}: scores {scores}, mean {mean:+.2f} "
        f"+- {se:.2f} (floor {MPC_GRID_FLOOR}, record +291.7 +- 0.94)")
    print_curve("c", res["evaluate"][0], f"{MPC_GRID}/mse_pixel_iter_020000.json")
    with open(f"{MPC_GRID}/interpretability/causal_matrix_iter_020000.json") as f:
        causal_rec = json.load(f)
    w, w_rec = res["causal_graph"], np.asarray(causal_rec["max"])
    say(f"[cli] (c) causal matrix (max, {cfg.latent_dim}x{cfg.latent_dim}): port mean "
        f"{w.mean():.4f}, {int((w >= 0.5).sum())} edges >= 0.5; record mean "
        f"{w_rec.mean():.4f}, {int((w_rec >= 0.5).sum())} edges >= 0.5 ({causal_rec['runs']} "
        f"runs); rows port | record:")
    for a, b in zip(w, w_rec):
        say("[cli]   " + " ".join(f"{v:.1f}" for v in a) + " | "
            + " ".join(f"{v:.1f}" for v in b))
    with open(HIGGINS_RECORD) as f:
        hig_rec = json.load(f)["gridworld_cf"]
    say(f"[cli] (c) Higgins conv {res['higgins']['conv']:.4f} (record "
        f"{hig_rec['higgins_conv_sum']}), spatial {res['higgins']['spatial']:.4f} (record "
        f"{hig_rec['higgins_spatial']}); chance {hig_rec['chance']}")
    check_launches("c", launches, add_launches(
        play_kernel_launches(cfg, CLI_GRID_EPISODES, int8=False),
        evaluate_launches(cfg, videos=True)))
    if not (mean >= MPC_GRID_FLOOR and np.isfinite(res["evaluate"]).all()
            and w.shape == (cfg.latent_dim,) * 2 and np.isfinite(w).all()
            and all(0.0 <= v <= 1.0 for v in res["higgins"].values())):
        raise AssertionError("cli (c): the evaluation failed its checks")

    # (d) int8 play on pong_cf_60k
    argv = ["--env", "pong", "--evaluate", "--load-from", MPC_PONG, "--mpc-int8",
            "--evaluations", "1", "--no-videos", *seed,
            "--out-dir", tempfile.mkdtemp(prefix="chip_smoke_cli_int8_")]
    cfg = cli_config(argv)
    res, launches, walls["int8_play"] = run_cli("d: int8 play", argv)
    totals.append(launches)
    say(f"[cli] (d) pong_cf_60k int8 play: score {res['scores']}")
    check_launches("d", launches, add_launches(
        play_kernel_launches(cfg, 1, int8=True), evaluate_launches(cfg, videos=False)))
    if not np.isfinite(res["evaluate"]).all():
        raise AssertionError("cli (d): non-finite evaluation")

    # (e) the h48 student served inside minipacman_cf
    argv = ["--env", ENV, "--evaluate", "--evaluations", "0", "--load-from", BUNDLE,
            "--student", STUDENT, *seed,
            "--out-dir", tempfile.mkdtemp(prefix="chip_smoke_cli_student_")]
    cfg = cli_config(argv)
    res, launches, walls["student"] = run_cli("e: student", argv)
    totals.append(launches)
    served = res["state"].params.transition["conv2"]["w"].shape[-1]
    curve = res["evaluate"][0]
    say(f"[cli] (e) served transition hidden {served}; pixel MSE at t+h: "
        + ", ".join(f"h={h} {curve[h]:.6g}" for h in (3, 5, 10, 20) if h < len(curve)))
    check_launches("e", launches, evaluate_launches(cfg, videos=True))
    if served != 48 or not np.isfinite(res["evaluate"]).all():
        raise AssertionError("cli (e): the h48 student did not serve")

    # (f) a directory of the reference's .pth files
    argv = ["--env", "gridworld", "--evaluate", "--evaluations", "1", "--load-from",
            REFERENCE_BUNDLE, "--no-videos", *seed,
            "--out-dir", tempfile.mkdtemp(prefix="chip_smoke_cli_pth_")]
    cfg = cli_config(argv)
    res, launches, walls["pth"] = run_cli("f: .pth bundle", argv)
    totals.append(launches)
    say(f"[cli] (f) reference_ab_gridworld play: score {res['scores']}")
    print_curve("f", res["evaluate"][0], f"{REFERENCE_BUNDLE}/mse_pixel_iter_005000.json")
    check_launches("f", launches, add_launches(
        play_kernel_launches(cfg, 1, int8=False), evaluate_launches(cfg, videos=False)))
    if not np.isfinite(res["evaluate"]).all():
        raise AssertionError("cli (f): non-finite evaluation")

    # one run in its own process, as a user starts it
    out = tempfile.mkdtemp(prefix="chip_smoke_cli_module_")
    argv = [sys.executable, "-m", "scmgan_tpu_torch", "--env", "gridworld", "--train-iters",
            "2", "--iters-per-video", "2", "--batch-size", "8", "--eval-batch-size", "8",
            "--eval-timesteps", "8", "--no-videos", *seed, "--out-dir", out]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=300)
    walls["subprocess"] = time.perf_counter() - t0
    written = sorted(os.listdir(out))
    say(f"[cli] subprocess {' '.join(argv[1:])}: exit {proc.returncode} in "
        f"{walls['subprocess']:.3f} s; wrote {written}")
    if proc.returncode != 0 or not {"model-encoder.npz", "opt_state.npz",
                                    "mse_pixel_iter_000002.json"} <= set(written):
        say(proc.stdout[-2000:])
        say(proc.stderr[-2000:])
        raise AssertionError("python -m scmgan_tpu_torch failed")
    say("[cli] wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return {"launches": add_launches(*totals), "walls": walls, "checks": checks,
            "d_errs": d_errs, "int8_checks": int8_checks,
            "videos": videos}

# ---------------------------------------------------------------------------
# the env zoo and the shipped 64x64 bundles of its envs
# ---------------------------------------------------------------------------

ZOO_ENVS = ("boxes", "gameoflife", "hardpong", "mediumpong", "minipong", "multibox",
            "realpong", "roomba", "roomba1", "rotating_boxes", "staticpong", "superpong")
ZOO_STEPS = 40
ZOO_BUNDLES = {"boxes": "pretrained_models/boxes_cf",
               "minipong": "pretrained_models/minipong_cf"}
EXCITATION_BUNDLES = (("gridworld", MPC_GRID), ("pong", "pretrained_models/pong_cf"),
                      ("minipacman", BUNDLE))
EXCITATION_SEEDS = 8       # scripts/excitation_zoo.py's tries
# - env steps on the card against the CPU: integer dynamics, exact; the
#   rotating square's corners come from f32 sin/cos, which the card and the
#   CPU may round differently in the last bit, so a pixel may differ only
#   where an edge's cross product is within EDGE_EPS of 0 on the CPU.
EDGE_EPS = 1e-3
# - the free-runs' first steps against the plain path: CURVE_RTOL.  boxes_cf
#   predicts its frames almost exactly (pixel MSE 1e-8 to 1e-5 over the first
#   steps, below CURVE_ATOL), so these curves get an absolute floor far
#   below their first step's MSE.
ZOO_CURVE_ATOL = 1e-10


def zoo_envs_on_card() -> dict:
    """(a) Each of the env zoo's names reset on the CPU at B = 100 and copied
    to the card; both copies stepped ZOO_STEPS times under the same actions,
    state, reward, done and frame held equal at every step.  Returns ms per
    card step (step and render, the first step left out)."""
    ms = {}
    for name in ZOO_ENVS:
        spec = get_env(name)
        cpu = spec.reset(BATCH, "cpu", torch.Generator().manual_seed(SEED))
        card = type(cpu)(*(x.to("cuda") for x in cpu))
        actions = np.random.default_rng(SEED).integers(0, spec.num_actions, (ZOO_STEPS, BATCH))
        seconds, edge_flips = 0.0, 0
        for t in range(ZOO_STEPS):
            a = torch.from_numpy(actions[t])
            cpu, r_cpu, d_cpu = spec.step(cpu, a, None)
            f_cpu = spec.render(cpu)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card, r_card, d_card = spec.step(card, a.to("cuda"), None)
            f_card = spec.render(card)
            torch.cuda.synchronize()
            seconds += (time.perf_counter() - t0) if t else 0.0
            for field, x, y in zip(type(cpu)._fields, cpu, card):
                if not torch.equal(x, y.cpu()):
                    raise AssertionError(f"zoo {name}: {field} differs at step {t}")
            if not (torch.equal(r_cpu, r_card.cpu()) and torch.equal(d_cpu, d_card.cpu())):
                raise AssertionError(f"zoo {name}: reward or done differs at step {t}")
            diff = (f_cpu != f_card.cpu()).any(dim=-1)
            if name == "rotating_boxes":
                edge = (rotbox_crosses(cpu.width, cpu.x, cpu.y, cpu.rotation).abs()
                        < EDGE_EPS).any(dim=1)
                edge_flips += int((diff & edge).sum())
                diff &= ~edge
            if diff.any():
                raise AssertionError(f"zoo {name}: {int(diff.sum())} pixels differ at step {t}")
        ms[name] = 1e3 * seconds / (ZOO_STEPS - 1)
        say(f"[zoo] (a) {name}: {ZOO_STEPS} steps at B={BATCH}, card equal to CPU"
            + (f" ({edge_flips} edge pixels differ, |cross| < {EDGE_EPS})"
               if name == "rotating_boxes" else "")
            + f"; {ms[name]:.4f} ms per card step (step + render)")
    return ms


def zoo_kernel_checks():
    """(b) Each kernel against its plain version at every shape the zoo's
    runs give it: boxes_cf (1 colour) and minipong_cf (3 colours), 64x64,
    4 actions, at B = 1 (the forward simulation, the sanity check), the
    evaluation's batch and each reconstruction window's; and the transition
    with 1 action (17 conv1 input channels, a gameoflife model) on
    ``init_world_model`` weights.  Returns (transition checks, decoder
    max errors)."""
    rng = np.random.default_rng(SEED + 10)
    params = inspect.signature(visualize.visualize_reconstruction).parameters
    t_viz, offsets = params["timesteps"].default, params["offsets"].default
    batches = sorted({1, BATCH, *(t_viz - 3 - o for o in offsets)})
    checks, d_errs = [], []
    for env, path in ZOO_BUNDLES.items():
        model = load_model(path, device="cuda")
        acts = model.transition["conv1"]["w"].shape[2] - 16
        pt, pd = (pack_transition_weights(model.transition, 16, acts),
                  pack_decoder_weights(model.decoder, 16))
        label = f" ({path.split('/')[-1]}, {acts} actions, {pd['color']} colour"
        for b in batches:
            z, a = binary_latents(rng, b), onehot_actions(rng, b, acts)
            checks.append(check_transition(pt, z, a, 16, label + ")"))
            d_errs.append(check_decoder(pd, z, label + ")"))
    one = init_world_model(torch.Generator(device="cuda").manual_seed(SEED), 16, 1, 1, 1, 1)
    z, a = binary_latents(rng, EXTRA_BATCH), onehot_actions(rng, EXTRA_BATCH, 1)
    checks.append(check_transition(pack_transition_weights(one.transition, 16, 1), z, a, 16,
                                   " (init_world_model, 1 action, 17 conv1 inputs)"))
    return checks, d_errs


def zoo_excitation(out_dir) -> dict:
    """(e) ``visualize_bptt`` on the bundles, as scripts/excitation_zoo.py
    runs it: seeds 0-7, the start frames drawn from the datasource; the
    first seed that fires per bundle, or None."""
    fired = {}
    for env, path in EXCITATION_BUNDLES:
        model = load_model(path, device="cuda")
        ds = allocate_datasource(env, seed=0, device="cuda")
        runs = []

        def recording(backtrack):
            def run(*a, **k):
                runs.append(backtrack(*a, **k))
                return runs[-1]
            return run

        fired[env] = None
        t0 = time.perf_counter()
        with patched(excitation_bptt, "backtrack", recording):
            for seed in range(EXCITATION_SEEDS):
                obs, *_ = ds.collect(1, 3, generator=torch.Generator(
                    device="cuda").manual_seed(100 + seed))
                with torch.no_grad(), no_tf32():
                    z0 = encode(model.encoder, obs[:, 0:3])
                with contextlib.redirect_stdout(io.StringIO()):
                    video = excitation_bptt.visualize_bptt(
                        model, z0, ds.binary_input_channels, steps=30, out_dir=out_dir,
                        seed=seed, filename=f"excitation_bptt_{env}_seed{seed}.mp4")
                if video is not None:
                    bt = runs[-1]
                    fired[env] = {"seed": seed, "t_hit": bt.t_hit,
                                  "reward": bt.rewards[bt.t_hit], "video": video}
                    break
        say(f"[zoo] (e) visualize_bptt {path}: "
            + (f"seed {fired[env]['seed']} fires at t+{fired[env]['t_hit']}, expected "
               f"reward {fired[env]['reward']:.4f}; video {fired[env]['video']}"
               if fired[env] else f"no seed of {EXCITATION_SEEDS} fires")
            + f" ({time.perf_counter() - t0:.3f} s)")
    if not any(fired.values()):
        raise AssertionError("visualize_bptt: no bundle fires")
    return fired


def zoo_phase():
    """The env zoo and the shipped bundles of its envs: (a) every new env
    on the card against the CPU; (b) the kernels at the runs' shapes;
    (c) ``--evaluate`` with Higgins on boxes_cf and minipong_cf; (d) the
    sanity check as a subprocess; (e) ``visualize_bptt``.  Returns the runs'
    launch counts, the kernel checks and the times."""
    t_phase = time.perf_counter()
    env_ms = zoo_envs_on_card()
    checks, d_errs = zoo_kernel_checks()
    totals, walls, frames_s = [], {}, {}
    with open(HIGGINS_RECORD) as f:
        hig_records = json.load(f)

    # (c) the evaluation with videos and Higgins; no play (the reward is 0)
    for env, path in ZOO_BUNDLES.items():
        argv = ["--env", env, "--evaluate", "--load-from", path, "--evaluations", "0",
                "--higgins", "--seed", str(SEED),
                "--out-dir", tempfile.mkdtemp(prefix=f"chip_smoke_zoo_{env}_")]
        cfg = cli_config(argv)
        res, launches, walls[env] = run_cli(f"zoo: {env}", argv)
        totals.append(launches)
        check_launches(env, launches, evaluate_launches(cfg, videos=True))
        curve = np.asarray(res["evaluate"][0])
        n = min(COMPARE_STEPS, len(curve))
        model = res["state"].params
        acts = model.transition["conv1"]["w"].shape[2] - cfg.latent_dim
        ds = allocate_datasource(env, seed=cfg.seed, device="cuda")
        pt = pack_transition_weights(model.transition, cfg.latent_dim, acts)
        pd = pack_decoder_weights(model.decoder, cfg.latent_dim)
        with torch.inference_mode():
            # evaluate() draws its batch from a generator seeded 3 * train_iter
            batch = ds.collect(cfg.eval_batch_size, cfg.eval_timesteps,
                               generator=torch.Generator(device="cuda").manual_seed(
                                   3 * cfg.start_iter))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = _free_run_stats(model, batch, acts)[0].cpu().numpy()
            free_s = time.perf_counter() - t0
            plain = _free_run_stats(
                model, tuple(x[:, :n + 2] for x in batch), acts,
                transition_fn=lambda z, a: transition_plain(pt, z, a, dtype=torch.bfloat16),
                decode_fn=lambda z: decode_plain(pd, z, dtype=torch.bfloat16))[0].cpu().numpy()
        frames_s[env] = cfg.eval_batch_size * (cfg.eval_timesteps - 2) / free_s
        say(f"[zoo] (c) {env} free-run alone, B={cfg.eval_batch_size} T={cfg.eval_timesteps} "
            f"(batch collected beforehand): {free_s:.3f} s, {frames_s[env]:.1f} frames/s")
        say(f"[zoo] (c) {env} pixel MSE, first {n} steps: run   "
            f"{np.array2string(curve[:n], precision=6)}")
        say(f"[zoo] (c) {env}                       plain "
            f"{np.array2string(plain, precision=6)}")
        print_curve(f"zoo {env}", curve, f"{path}/mse_pixel_iter_010000.json")
        rec = hig_records[f"{env}_cf"]
        hig = res["higgins"]
        say(f"[zoo] (c) {env} Higgins conv {hig['conv']:.4f} (record "
            f"{rec['higgins_conv_sum']}), spatial {hig['spatial']:.4f} (record "
            f"{rec['higgins_spatial']}); chance {rec['chance']}")
        if not np.allclose(again[:len(curve)], curve, rtol=1e-5, atol=1e-12):
            raise AssertionError(f"zoo {env}: the re-collected batch does not reproduce the run")
        if not np.allclose(curve[:n], plain, rtol=CURVE_RTOL, atol=ZOO_CURVE_ATOL):
            raise AssertionError(f"zoo {env}: the free-run disagrees with the plain path")
        if not (np.isfinite(res["evaluate"]).all()
                and all(0.0 <= v <= 1.0 for v in hig.values())):
            raise AssertionError(f"zoo {env}: the evaluation failed its checks")

    # (d) the sanity check in its own process, as a user starts it
    out = tempfile.mkdtemp(prefix="chip_smoke_sanity_")
    argv = [sys.executable, "-m", "scmgan_tpu_torch.analysis.sanity", "--env", "minipong",
            "--load-from", ZOO_BUNDLES["minipong"], "--out-dir", out]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=300)
    walls["sanity"] = time.perf_counter() - t0
    png = os.path.join(out, "sanity_reconstruction.png")
    size = os.path.getsize(png) if os.path.exists(png) else 0
    say(f"[zoo] (d) {' '.join(argv[1:])}: exit {proc.returncode} in {walls['sanity']:.3f} s; "
        f"{png}: {size} bytes")
    if proc.returncode != 0 or size == 0:
        say(proc.stdout[-2000:])
        say(proc.stderr[-2000:])
        raise AssertionError("python -m scmgan_tpu_torch.analysis.sanity failed")

    t0 = time.perf_counter()
    fired = zoo_excitation(tempfile.mkdtemp(prefix="chip_smoke_excitation_"))
    walls["excitation"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    say("[zoo] wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return {"launches": add_launches(*totals), "walls": walls, "checks": checks,
            "d_errs": d_errs, "env_ms": env_ms, "frames_s": frames_s, "excitation": fired}

# ---------------------------------------------------------------------------
# make a student: the int8 variants and decoder, the distillation steps, the
# command line that makes a student, and the shipped students' gates
# ---------------------------------------------------------------------------

# Tolerances, each with its reason:
# - the int8 variants (halo, split, ring) with the f32 epilogue compute the
#   int32 sums exactly (f64 convs) and round the epilogue as the kernel does,
#   so every bit equals the kernel's (each variant with its own head).
# - the int8 decoder: exact int32 sums (f64 convs) and the same f32
#   epilogue on both devices, so the card's logits equal the CPU's bit for
#   bit (on DECODE_CPU_BATCH samples).  Against the bf16 decoder kernel, as
#   sigmoids: the mean error of the JAX package's serving tolerance
#   (tests/test_native_and_pallas.py:324).  Its max bound (0.1) was set on
#   a random 8-latent model; on minipacman_cf's trained decoder the JAX
#   function itself exceeds it (the port is bit-equal to JAX on the CPU:
#   max 0.178 against the exact f32 decoder, at 9e-5 of the pixels past
#   0.1), so the max is printed beside the f32 decoder's, not held.
DECODE_INT8_MAE = 0.01
DECODE_CPU_BATCH = 8
# - the distillation steps on the card against the CPU (TF32 off): the convs
#   sum in other orders, so the loss agrees to TRAIN_LOSS_RTOL; a fresh
#   Adam's first step moves each parameter by lr * sign(g), so no parameter
#   is more than 2 lr + TRAIN_PARAM_ATOL apart (phase 6's limits).
DISTILL_LR = 1e-3
DISTILL_CHECK = {"batch": 2, "rollout": 3, "horizon": 4}
# (c) the student made at full width, the script's defaults otherwise
DISTILL_ARGV = ["--env", ENV, "--teacher", BUNDLE, "--hidden", "48", "--iters", "60",
                "--qat-from", "0.5", "--qat-recal", "10", "--gt-iters", "20",
                "--eval-seeds", "1"]
GATE_ARGV = []                 # the script's gate: B = 100 x 30
GATE_TIMESTEPS = 30
DISTILL_LOSS_WINDOW = 10       # BCE of the last 10 iterations below the first 10
# (d) the shipped students' gates, 4 eval seeds each
SHIPPED_STUDENTS = ("pretrained_models/minipacman_student_h48",
                    "pretrained_models/minipacman_student_h64",
                    "pretrained_models/minipacman_student_h80")
GATE_SEEDS = 4
HOLD_GATE = True
# (c') the step kinds profiled at the script's defaults
PROFILE_DISTILL = {"batch": 16, "rollout": 20, "horizon": 16}


class FixedNoise:
    """A ``DistillNoise`` whose draws were made beforehand: the same batch
    and mix mask for the card's step and the CPU's."""

    def __init__(self, batch, use, device):
        self.batch = tuple(x.to(device) for x in batch)
        self.use = use.to(device)

    def rollout(self, spec, batch_size, timesteps):
        return self.batch

    def mix(self, p_on_policy, steps, batch_size):
        return self.use


def gate_launches(seeds: int) -> dict:
    """The kernel launches of ``seeds`` fidelity gates at GATE_TIMESTEPS:
    teacher and exact student through the bf16 kernels, the int8 student."""
    t = GATE_TIMESTEPS
    return {"fused_transition": seeds * 2 * (t - 1), "fused_decode": seeds * 3 * (t - 2),
            "int8_transition": seeds * (t - 1)}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(x, device) for x in tree))
    return tree.detach().to(device).clone()


def distill_variants(model, qt, z, a):
    """(a) halo, split and ring on the card against the int8 kernel (the
    static teacher packing and the calibrated h48 packing), the bf16
    epilogue's agreement, the int8 decoder against the decoder kernel."""
    packings = {"minipacman_cf static": quantize_transition(model.transition),
                "h48 calibrated": qt}
    zi = z.to(torch.int8)
    times, agree = {}, {}
    with torch.inference_mode():
        for label, q in packings.items():
            heads = {"sigmoid": transition_int8(q, z, a), "logit": transition_int8_v2(q, z, a)}
            torch.cuda.synchronize()
            for name, fn, head in (("halo", transition_int8_halo, "sigmoid"),
                                   ("split", transition_int8_split, "sigmoid"),
                                   ("ring", transition_int8_ring, "logit")):
                got = fn(q, z, a, epilogue_dtype=torch.float32)
                n_diff = int((got != heads[head]).sum())
                bf = fn(q, z, a, epilogue_dtype=torch.bfloat16)
                agree[f"{name} {label}"] = float((bf == got).float().mean())
                times[f"{name} {label}"] = cuda_ms(
                    lambda: fn(q, z, a, epilogue_dtype=torch.float32), iters=3, warmup=1)
                say(f"[distill] (a) B={z.shape[0]} {name} ({label}, f32 epilogue) against the "
                    f"int8 kernel's {head} head: {n_diff} of {got.numel()} bits differ "
                    f"(limit 0); bf16 epilogue agrees on {agree[f'{name} {label}']:.6f} of "
                    f"the bits; plain route {times[f'{name} {label}']:.3f} ms per call")
                if n_diff:
                    raise AssertionError(f"transition_int8_{name} ({label}) disagrees with "
                                         "the int8 kernel")
        qd = quantize_decoder(model.decoder)
        pd = pack_decoder_weights(model.decoder, z.shape[-1])
        logits = decode_int8(qd, zi)
        n = DECODE_CPU_BATCH
        on_cpu = decode_int8(to_device(qd, "cpu"), zi[:n].cpu())
        cpu_equal = bool(torch.equal(logits[:n].cpu(), on_cpu))
        got = torch.sigmoid(logits)
        err = (got - torch.sigmoid(fused_decode(pd, z).float())).abs()
        err_f32 = (got - torch.sigmoid(decode(model.decoder, z))).abs()
        times["decode_int8"] = cuda_ms(lambda: decode_int8(qd, zi), iters=3, warmup=1)
    mae, worst = float(err.mean()), float(err.max())
    say(f"[distill] (a) decode_int8 B={z.shape[0]}: logits on the card bit-equal to the CPU's "
        f"(first {n}): {cpu_equal}; against the decoder kernel, sigmoid: MAE {mae:.4g} "
        f"(limit {DECODE_INT8_MAE}), max {worst:.4g} ({float((err > 0.1).float().mean()):.3g} "
        f"of the pixels past 0.1); against the exact f32 decoder: MAE "
        f"{float(err_f32.mean()):.4g}, max {float(err_f32.max()):.4g}; plain route "
        f"{times['decode_int8']:.3f} ms per call")
    if not (cpu_equal and mae < DECODE_INT8_MAE):
        raise AssertionError("decode_int8 disagrees with the CPU or the decoder kernel")
    return {"ms": times, "bf16_agreement": agree, "decode_mae": mae, "decode_max": worst,
            "decode_max_vs_f32": float(err_f32.max())}


def distill_steps_card_vs_cpu(model, student, ds):
    """(b) one distillation step, one QAT step and one GT fine-tune step on
    the card against the same step on the CPU (TF32 off): same weights, same
    injected batch, mix mask and activation scales (calibrated on the card),
    a fresh optimizer each."""
    c = DISTILL_CHECK
    spec = get_env(ENV)
    gen = torch.Generator().manual_seed(SEED)
    cpu_model = to_device(model, "cpu")
    with no_tf32():
        act_scale = distill.calibration_scales(
            model, student, distill.DistillNoise(torch.Generator(device="cuda").manual_seed(
                SEED)).calibration(ds), spec.num_actions)
    runs = {"distill": (c["rollout"] + 2, False), "distill_qat": (c["rollout"] + 2, True),
            "gt_finetune": (c["horizon"] + 3, True)}
    out = {}
    for kind, (timesteps, qat) in runs.items():
        batch = rollout(spec, gen, c["batch"], timesteps)
        use = torch.rand((c["rollout"], c["batch"]), generator=gen) < 0.5
        res = {}
        for dev in ("cuda", "cpu"):
            sp = to_device(student, dev)
            opt = distill.DistillOptimizer(sp, DISTILL_LR, 10)
            teacher = model if dev == "cuda" else cpu_model
            if kind == "gt_finetune":
                step = distill.make_gt_finetune_step(spec, teacher, opt, c["batch"],
                                                     c["horizon"])
                args = ()
            else:
                step = distill.make_distill_step(spec, teacher, opt, c["batch"], c["rollout"],
                                                 qat=qat)
                args = (0.5,)
            extra = (to_device(act_scale, dev),) if qat else ()
            with no_tf32():
                sp, loss, _ = step(sp, FixedNoise(batch, use, dev), *args, *extra)
            res[dev] = (float(loss), dict(flatten_tree(to_device(sp, "cpu"))))
        loss_c, loss_h = res["cuda"][0], res["cpu"][0]
        diffs = [(res["cuda"][1][k] - v).abs() for k, v in res["cpu"][1].items()
                 if "/sn/" not in k]
        worst = max(float(d.max()) for d in diffs)
        flips = sum(int((d > TRAIN_PARAM_ATOL).sum()) for d in diffs)
        n_params = sum(d.numel() for d in diffs)
        limit = 2 * DISTILL_LR + TRAIN_PARAM_ATOL
        say(f"[distill] (b) {kind} step B={c['batch']} card vs CPU (TF32 off): loss "
            f"{loss_c:.8g} / {loss_h:.8g} (rtol {TRAIN_LOSS_RTOL}); largest parameter "
            f"difference after Adam {worst:.3g} (limit {limit:.3g}); {flips} of {n_params} "
            f"parameters more than {TRAIN_PARAM_ATOL} apart (gradient signs that differ)")
        if not (np.isclose(loss_c, loss_h, rtol=TRAIN_LOSS_RTOL, atol=0) and worst <= limit):
            raise AssertionError(f"the {kind} step on the card disagrees with the CPU")
        out[kind] = {"loss": (loss_c, loss_h), "param_diff": worst, "sign_flips": flips}
    return out


def make_a_student(teacher_decoder):
    """(c) ``python -m scmgan_tpu_torch.cli.distill_student`` in its own
    process: an h48 student from minipacman_cf, with its run record."""
    out = tempfile.mkdtemp(prefix="chip_smoke_student_")
    argv = [sys.executable, "-m", "scmgan_tpu_torch.cli.distill_student",
            *DISTILL_ARGV, *GATE_ARGV, "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = [x for x in proc.stdout.splitlines() if x.startswith('{"run":')]
    say(f"[distill] (c) {' '.join(argv[1:])}: exit {proc.returncode} in {wall:.3f} s")
    if proc.returncode != 0 or len(lines) != 1:
        say(proc.stdout[-3000:])
        say(proc.stderr[-3000:])
        raise AssertionError("python -m scmgan_tpu_torch.cli.distill_student failed")
    run = json.loads(lines[0])["run"]
    with open(os.path.join(out, "fidelity.json")) as f:
        fid = json.load(f)
    bce = np.asarray(run["bce"])
    w = DISTILL_LOSS_WINDOW
    say(f"[distill] (c) stage seconds {run['seconds']}; ms per iteration {run['ms_per_iter']}")
    say(f"[distill] (c) BCE first {bce[:max(w, 1)].mean():.5f}, last {bce[-max(w, 1):].mean():.5f}"
        f" (mean of {w}, held {'' if w else 'not '}falling); bit accuracy last "
        f"{run['bit_acc'][-1]:.5f}; GT gate MSE first {run['gt_gate_mse'][0]:.6f} last "
        f"{run['gt_gate_mse'][-1]:.6f}; the student's gate: mse10_delta_pct "
        f"{fid['mse10_delta_pct']:.4f}, within_1pct {fid['within_1pct']}")
    say(f"[distill] (c) launches by stage {run['launches']}")
    losses = run["bce"] + run["bit_acc"] + run["gt_gate_mse"] + run["gt_mean_mse"]
    if not (np.isfinite(losses).all() and len(run["bce"]) and len(run["gt_gate_mse"])):
        raise AssertionError("the student's run has a non-finite or missing loss")
    if w and not bce[-w:].mean() < bce[:w].mean():
        raise AssertionError("the distillation's BCE did not fall")
    for name in ("model-transition.npz", "model-decoder.npz", "fidelity.json"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"the student's {name} is missing")
    written = load_pytree(os.path.join(out, "model-decoder.npz"), "cpu")
    for path, leaf in flatten_tree(teacher_decoder):
        if not np.array_equal(dict(flatten_tree(written))[path].numpy(), leaf.cpu().numpy()):
            raise AssertionError(f"model-decoder.npz differs from the teacher's at {path}")
    if fid["teacher_hash"] != ckpt.bundle_hash(BUNDLE):
        raise AssertionError("fidelity.json records another teacher's hash")
    zero = {k: 0 for k in counters()}
    want = {"distill": zero, "gt_finetune": zero, "fidelity": gate_launches(1)}
    if run["launches"] != want:
        raise AssertionError(f"the student's run launched {run['launches']}, it implies {want}")
    return {"run": run, "fidelity": fid, "wall": wall, "launches": add_launches(
        *run["launches"].values())}


@contextlib.contextmanager
def pytorch_default_precision():
    """PyTorch's default precision inside the block (cuDNN convs may use
    TF32, matmuls may not), as the ``distill_student`` process runs; this
    script's setting (no TF32) restored after it."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def profile_distill_steps(model, ds):
    """(c') the three step kinds at the script's defaults (B = 16, rollout
    20; GT B = 16, horizon 16) on a fresh h48 student in this process, at
    PyTorch's default precision as the command runs them: ms per step (3
    steps after one warm-up), the rollout's share, peak memory, and one
    profiled step each (the card's busy share, time by kernel family)."""
    b, t, horizon = (PROFILE_DISTILL[k] for k in ("batch", "rollout", "horizon"))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = distill.DistillNoise(gen)
    spec = ds.spec
    student = init_transition(gen, model.encoder["conv4"]["w"].shape[-1], spec.num_actions,
                              hidden=48)
    act_scale = distill.calibration_scales(model, student, noise.calibration(ds),
                                           spec.num_actions)
    opt = distill.DistillOptimizer(student, DISTILL_LR, 100)
    kinds = {   # (step, its arguments, the length of its rollout)
        "distill": (distill.make_distill_step(spec, model, opt, b, t), (1.0,), t + 2),
        "distill_qat": (distill.make_distill_step(spec, model, opt, b, t, qat=True),
                        (1.0, act_scale), t + 2),
        "gt_finetune": (distill.make_gt_finetune_step(spec, model, opt, b, horizon),
                        (act_scale,), horizon + 3),
    }
    out = {}
    for kind, (step, args, t_len) in kinds.items():
        state = {"student": student}

        def one():
            state["student"] = step(state["student"], noise, *args)[0]

        one()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(3):
            one()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t0 = time.perf_counter()
        noise.rollout(spec, b, t_len)
        torch.cuda.synchronize()
        rollout_ms = (time.perf_counter() - t0) * 1e3
        wall, busy, by_name = profile_device(one)
        student = state["student"]
        say(f"[distill] (c') {kind} step at full width, B={b}: {ms:.2f} ms a step, its "
            f"rollout of {t_len} steps alone {rollout_ms:.2f} ms, peak {peak:.2f} GiB; "
            f"profiled: {wall * 1e3:.2f} ms wall, the card busy {busy * 1e3:.2f} ms "
            f"({100 * busy / wall:.1f}%)")
        print_top_kernels(f"distill {kind}", by_name, busy, n=4)
        out[kind] = {"ms": ms, "rollout_ms": rollout_ms, "peak_gib": peak,
                     "busy_share": busy / wall}
    return out


def pretrained_snapshot():
    return {os.path.join(d, f): (os.path.getsize(os.path.join(d, f)),
                                 os.path.getmtime(os.path.join(d, f)))
            for d in SHIPPED_STUDENTS for f in sorted(os.listdir(d))}


def shipped_gates(model, ds, z, a):
    """(d) ``--fidelity-only --eval-seeds 4`` on copies of the three shipped
    students, in this process; each calibrated packing first held against the
    plain int8 version.  Nothing is written under pretrained_models/."""
    before = pretrained_snapshot()
    records, totals = {}, []
    for path in SHIPPED_STUDENTS:
        name = path.split("/")[-1]
        student = load_pytree(f"{path}/model-transition.npz", "cuda")
        hidden = student["conv2"]["w"].shape[-1]
        packed = calibrate_student(model, student, ds, 0).packed   # the gate's packing
        check_int8(f"{name} calibrated", packed, z.to(torch.int8), a, "logit")
        out = tempfile.mkdtemp(prefix=f"chip_smoke_gate_{name}_")
        shutil.copytree(path, out, dirs_exist_ok=True)
        argv = ["--env", ENV, "--teacher", BUNDLE, "--hidden", str(hidden), "--fidelity-only",
                "--eval-seeds", str(GATE_SEEDS), *GATE_ARGV, "--out", out]
        zero_counters()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = distill_student.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counters()
        totals.append(launches)
        fid = res["fidelity"]
        with open(f"{path}/fidelity.json") as f:
            rec = json.load(f)
        say(f"[distill] (d) {name}: 4-seed MSE@t+10 delta {fid['mse10_delta_pct']:+.2f} ± "
            f"{fid['mse10_delta_se_pct']:.2f}% (per seed "
            f"{', '.join(f'{d:+.2f}' for d in fid['mse10_delta_per_seed'])}), within_1pct "
            f"{fid['within_1pct']}; record {rec['mse10_delta_pct']:+.2f} ± "
            f"{rec['mse10_delta_se_pct']:.2f}%; {wall:.3f} s; launches {launches}")
        records[name] = {k: fid[k] for k in ("mse10_delta_pct", "mse10_delta_se_pct",
                                             "mse10_delta_per_seed", "within_1pct")}
        records[name]["wall"] = wall
        if launches != gate_launches(GATE_SEEDS):
            raise AssertionError(f"{name}: launches {launches}, the gate implies "
                                 f"{gate_launches(GATE_SEEDS)}")
        if HOLD_GATE and not fid["within_1pct"]:
            raise AssertionError(f"{name}: the port's gate fails the 1% limit")
    if pretrained_snapshot() != before:
        raise AssertionError("something was written under pretrained_models/")
    return records, add_launches(*totals)


# (e) the library ops: f32 matmuls and convs in other orders on the
# two devices (TF32 off); the CSRN carries its state through 64 rows a sweep.
LIBRARY_RTOL, LIBRARY_ATOL = 1e-4, 1e-5
CSRN_CHANNELS = 32             # examples/csrn_demo.py's SimpleFCN


def library_ops_on_card(z):
    """(e) the CSRN, CoordConv, the gaussian smoothing, random_eps,
    hypersphere_norm and cov on the card against the CPU: the CSRN and
    CoordConv at examples/csrn_demo.py's size (1 x 64 x 64, 32 channels),
    the rest on the latents ``z`` (B = 100, 64 x 64 x 16)."""
    gen = torch.Generator().manual_seed(SEED)
    x = torch.rand((1, 64, 64, CSRN_CHANNELS), generator=gen)
    frames = torch.rand((4, 64, 64, 3), generator=gen)
    u = torch.rand(z.shape, generator=gen)
    cases = {
        "csrn_apply": (lambda p, t: csrn.csrn_apply(p, t),
                       csrn.csrn_init(gen, CSRN_CHANNELS, exploding_init=False), x),
        "coordconv2d": (lambda p, t: coordconv.coordconv2d(p, t),
                        coordconv.coordconv2d_init(gen, 3, CSRN_CHANNELS), frames),
        "gaussian_smooth2d": (lambda p, t: smoothing.gaussian_smooth2d(t, 5, 1.0), {}, frames),
        "random_eps": (lambda p, t: random_eps(p=0.3, u=t), {}, u),
        "hypersphere_norm": (lambda p, t: hypersphere_norm(t), {}, z.cpu()),
        "cov": (lambda p, t: stats.cov(t.reshape(t.shape[0], -1)[:, :256]), {}, z.cpu()),
    }
    errs, ms = {}, {}
    with torch.inference_mode(), no_tf32():
        for name, (fn, params, t) in cases.items():
            want = fn(params, t)
            pc, tc = to_device(params, "cuda"), t.cuda()
            got = fn(pc, tc)
            torch.cuda.synchronize()
            errs[name] = float((got.cpu() - want).abs().max())
            ms[name] = cuda_ms(lambda: fn(pc, tc), iters=3, warmup=1)
            ok = bool(torch.allclose(got.cpu(), want, rtol=LIBRARY_RTOL, atol=LIBRARY_ATOL))
            say(f"[distill] (e) {name} {tuple(t.shape)} card vs CPU: max |diff| "
                f"{errs[name]:.3g} (rtol {LIBRARY_RTOL}, atol {LIBRARY_ATOL}); "
                f"{ms[name]:.3f} ms per call")
            if not ok:
                raise AssertionError(f"{name} on the card disagrees with the CPU")
        drawn = random_eps(torch.Generator(device="cuda").manual_seed(SEED), 0.3, *z.shape)
        if drawn.shape != z.shape or abs(float(drawn.mean()) - 0.3) > 0.01:
            raise AssertionError("random_eps drawn on the card is not Bernoulli(0.3)")
    return {"max_abs_err": errs, "ms": ms}


def distill_phase(model, student, qt, ds):
    """Make a student: (a) the int8 variants and decoder on the card; (b) one
    step of each kind card against CPU; (c) the command line that makes an
    h48 student; (d) the shipped students' gates.  Returns the launches of
    (c) and (d), and what each part measured."""
    t_phase = time.perf_counter()
    walls = {}
    with torch.inference_mode():
        obs = ds.collect(BATCH, 3, generator=torch.Generator(device="cuda").manual_seed(SEED))[0]
        z = (encode(model.encoder, obs) > 0.5).to(torch.float32)
    a = onehot_actions(np.random.default_rng(SEED + 3), BATCH, ds.binary_input_channels)
    t0 = time.perf_counter()
    variants = distill_variants(model, qt, z, a)
    walls["variants"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = distill_steps_card_vs_cpu(model, student, ds)
    walls["steps"] = time.perf_counter() - t0
    made = make_a_student(model.decoder)
    walls["make_a_student"] = made["wall"]
    t0 = time.perf_counter()
    with pytorch_default_precision():
        profiled = profile_distill_steps(model, ds)
    walls["profiled_steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gates, gate_totals = shipped_gates(model, ds, z, a)
    walls["shipped_gates"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    library = library_ops_on_card(z)
    walls["library_ops"] = time.perf_counter() - t0
    walls["phase"] = time.perf_counter() - t_phase
    say("[distill] wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return {"launches": add_launches(made["launches"], gate_totals), "walls": walls,
            "variants": variants, "steps": steps, "student": made, "profiled": profiled,
            "gates": gates, "library": library}

# ---------------------------------------------------------------------------
# the host data path: actors play minipacman on the host into a replay buffer
# ---------------------------------------------------------------------------

REPLAY_CAPACITY, REPLAY_MAX_LEN, REPLAY_MIN = 50, 150, 4
REPLAY_INGEST_S = 3.0        # the ingest window for 1 and for 2 actors
REPLAY_ACTORS = 2            # the datasource that trains and serves
# (batch, timesteps, training): a training batch and the free-run's test batch
REPLAY_BATCHES = ((32, 10, True), (BATCH, TIMESTEPS, False))
REPLAY_STITCH_REPEATS, REPLAY_PLAIN_REPEATS, REPLAY_COPY_REPEATS = 5, 2, 5
REPLAY_VIDEO_FRAMES = 20
REPLAY_CURVE_STEPS = (1, 3, 5, 10, 20, 50)   # free-run horizons printed beside phase 4's


def replay_datasource(n_actors: int, seed: int):
    """A HostReplayDatasource whose actors play the port's minipacman on the
    host (``HostEnv`` on the CPU: 64x64x3 frames, 5 actions, 2 rewards), HWC
    frames stored channels-first, under a seeded random policy (``HostEnv``
    has no ``action_space``).  Test harness, not a datasource of the package."""
    spec = get_env(ENV)
    envs = itertools.count()
    rng = np.random.default_rng(seed)

    def make_env(*args, **kwargs):
        return HostEnv(spec, seed=seed + next(envs), device="cpu")

    return HostReplayDatasource(
        make_env, num_actions=spec.num_actions, num_rewards=spec.num_rewards,
        channels=spec.channels, convert_frame=lambda s: np.moveaxis(s, -1, 0),
        min_buffer_len=REPLAY_MIN, capacity=REPLAY_CAPACITY,
        max_trajectory_len=REPLAY_MAX_LEN, seed=seed,
        policy=lambda state: int(rng.integers(spec.num_actions)),
        name=ENV, height=spec.height, width=spec.width, n_actors=n_actors, device="cuda")


def ingest(ds, window: float) -> dict:
    """Start the actors and count the episodes and frames that land in the
    buffer over ``window`` seconds (env construction included)."""
    frames = [0]
    add = ds.buffer.add

    def counting(episode):
        frames[0] += len(episode[0])
        add(episode)

    ds.buffer.add = counting
    t0 = time.perf_counter()
    ds._ensure_started()
    time.sleep(window)
    episodes, n = ds.buffer.version, frames[0]
    dt = time.perf_counter() - t0
    return {"episodes": episodes, "frames": n, "s": dt, "episodes_per_s": episodes / dt,
            "frames_per_s": n / dt}


def frozen_copy(ds):
    """A datasource over a snapshot of ``ds``'s buffers (taken under its lock),
    with no actor: its batches do not move while ``ds``'s actors play."""
    snap = HostReplayDatasource(
        ds.make_env, num_actions=ds.binary_input_channels,
        num_rewards=ds.scalar_output_channels, channels=ds.conv_input_channels,
        min_buffer_len=1, capacity=ds.buffer.capacity,
        max_trajectory_len=ds.actor.max_trajectory_len, seed=SEED, name=ds.name,
        height=ds.height, width=ds.width, device=ds.device)
    snap._ensure_started = lambda: None
    src, dst = ds.buffer, snap.buffer
    with src._lock:
        dst._train, dst._test = list(src._train), list(src._test)
        dst._train_slot_versions = list(src._train_slot_versions)
        dst._test_slot_versions = list(src._test_slot_versions)
    return snap


def check_clips(ds, batch, training: bool) -> int:
    """Every stitched clip (the steps up to and including each done) is a
    run of consecutive steps of one stored episode, ending before its last
    step, with its rewards and actions; returns the number of clips."""
    states, rewards, dones, actions = batch
    eps = ds.buffer._train if training else ds.buffer._test
    index = {}
    for e, (frames, _, _) in enumerate(eps):
        for s in range(len(frames) - 1):
            index.setdefault(frames[s].tobytes(), []).append((e, s))
    n_clips = 0
    for b in range(states.shape[0]):
        t = 0
        for end in np.flatnonzero(dones[b]):
            n = end + 1 - t
            if not any(s + n <= len(eps[e][0]) - 1
                       and np.array_equal(eps[e][0][s:s + n], states[b, t:end + 1])
                       and np.array_equal(eps[e][1][s:s + n], rewards[b, t:end + 1])
                       and np.array_equal(eps[e][2][s:s + n], actions[b, t:end + 1])
                       for e, s in index.get(states[b, t].tobytes(), ())):
                raise AssertionError(f"stitched clip row {b} steps {t}..{end} is not a "
                                     "run of one stored episode")
            n_clips += 1
            t = end + 1
        if t != states.shape[1]:
            raise AssertionError(f"row {b} does not end with a done")
    return n_clips


def host_ms(fn, repeats: int) -> float:
    """Median host milliseconds of ``fn`` over ``repeats`` calls, after one."""
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def copy_ms(host_batch) -> float:
    """Milliseconds to move a stitched batch to the card, NHWC, synchronized."""
    def move():
        to_device_batch(*host_batch, "cuda")
        torch.cuda.synchronize()
    return host_ms(move, REPLAY_COPY_REPEATS)


def replay_batches(ds) -> dict:
    """(c): collect on the card bit-equal to get_trajectories of the same
    seed, the clips' structure, and the stitch and copy times."""
    snap = frozen_copy(ds)
    out = {}
    for b, t, training in REPLAY_BATCHES:
        got = snap.collect(b, t, generator=torch.Generator(device="cuda").manual_seed(SEED + 30),
                           training=training)
        again = torch.Generator(device="cuda").manual_seed(SEED + 30)
        draw = torch.randint(0, 2 ** 63 - 1, (1,), device=again.device, generator=again)
        snap._rng = np.random.default_rng(int(draw))
        host = snap.get_trajectories(b, t, training=training)
        want = (np.moveaxis(host[0], 2, -1), host[1], host[2], host[3].astype(np.int64))
        for g, w in zip(got, want):
            if not (g.device.type == snap.device.type and g.is_contiguous()
                    and torch.equal(g.cpu(), torch.from_numpy(np.ascontiguousarray(w)))):
                raise AssertionError(f"collect({b}, {t}) differs from get_trajectories")
        n_clips = check_clips(snap, host, training)
        row = {"mb": host[0].nbytes / 1e6, "clips": n_clips,
               "stitch_ms": host_ms(lambda: snap.get_trajectories(b, t, training=training),
                                    REPLAY_STITCH_REPEATS),
               "plain_ms": host_ms(lambda: snap.get_trajectories_plain(b, t, training=training),
                                   REPLAY_PLAIN_REPEATS),
               "copy_ms": copy_ms(host)}
        out[(b, t)] = row
        say(f"[replay] (c) collect({b}, {t}, training={training}) on the card bit-equal to "
            f"get_trajectories of the same seed, NHWC; {n_clips} clips, each a run of one "
            f"stored episode with done at its end; states {row['mb']:.1f} MB f32: native "
            f"stitch {row['stitch_ms']:.3f} ms, plain Python loop {row['plain_ms']:.3f} ms, "
            f"copy to the card (channels moved last there) {row['copy_ms']:.3f} ms")
    return out


def replay_train(ds, latent, phase6_ms) -> dict:
    """(d): ``trainer.train`` from the buffer at full width, its evaluation
    hook on the test split through the kernels, one profiled iteration."""
    num_actions = ds.binary_input_channels
    bf16 = torch.bfloat16
    cfg = Config(env=ENV, seed=SEED, train_iters=TRAIN_ITERS, iters_per_video=TRAIN_ITERS,
                 enable_disentanglement_loss=True, enable_action_control_loss=True,
                 counterfactual_horizon=2, eval_batch_size=BATCH,
                 eval_timesteps=TRAIN_EVAL_TIMESTEPS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    state = trainer.init_train_state(cfg, ds.spec, gen)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_replay_")
    rows, hook, clock = [], {}, {}

    def eval_fn(st, it):
        collect = ds.collect

        def keep(*args, **kwargs):
            hook["batch"] = collect(*args, **kwargs)
            return hook["batch"]

        ds.collect = keep
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            hook["result"] = measure_prediction_mse(
                st.params, ds, train_iter=it, batch_size=cfg.eval_batch_size,
                timesteps=cfg.eval_timesteps, use_training_set=False, out_dir=out_dir,
                make_plots=False, generator=torch.Generator(device="cuda").manual_seed(SEED + 2))
        finally:
            del ds.collect
        torch.cuda.synchronize()
        hook["s"] = time.perf_counter() - t0
        hook["params"] = copy_params(st.params, "cuda")

    def log_fn(it, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rows.append({"iter": it, "horizon": trainer.horizon_at(cfg, it),
                     "ms": 1e3 * (now - clock["t"]), **{k: float(v) for k, v in metrics.items()}})
        clock["t"] = now

    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = clock["t"] = time.perf_counter()
    state = trainer.train(cfg, ds, state, eval_fn=eval_fn, log_fn=log_fn, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counters()
    peak = torch.cuda.max_memory_allocated()
    rows[-1]["ms_without_eval"] = rows[-1]["ms"] - 1e3 * hook["s"]
    by_h = {}
    for r in rows:
        r["rec_per_step"] = r["reconstruction_loss"] / (r["horizon"] - 2)
        by_h.setdefault(r["horizon"], []).append(r.get("ms_without_eval", r["ms"]))
    say("[replay] (d) mean ms per iteration by horizon, replay buffer (collect included) / "
        "phase 6's device env: " + ", ".join(
            f"h{h} {np.mean(v):.2f} / " + (f"{phase6_ms[h]:.2f}" if h in phase6_ms else "-")
            for h, v in sorted(by_h.items())))
    say(f"[replay] (d) train() {train_s:.3f} s wall for {len(rows)} iterations, the actors "
        f"playing; peak device memory {peak / 2**30:.3f} GiB; evaluation hook (test split, "
        f"B = {cfg.eval_batch_size} x {cfg.eval_timesteps}) {hook['s']:.3f} s; launches "
        f"{launches}")
    if launches != {"fused_transition": TRAIN_EVAL_TIMESTEPS - 1,
                    "fused_decode": TRAIN_EVAL_TIMESTEPS - 2, "int8_transition": 0}:
        raise AssertionError(f"the replay evaluation did not run the kernels: {launches}")
    keys = ("loss", "reward_loss", "reconstruction_loss", "cf_disentanglement_loss",
            "cf_control_loss")
    if not np.isfinite([[r[k] for k in keys] for r in rows]).all():
        raise AssertionError("a training loss from the replay buffer is not finite")
    first = np.mean([r["rec_per_step"] for r in rows[:4]])
    last = np.mean([r["rec_per_step"] for r in rows[-4:]])
    say(f"[replay] (d) reconstruction loss per step: first 4 iterations {first:.6f}, last 4 "
        f"{last:.6f} ({100 * (last - first) / first:+.1f}%); loss first {rows[0]['loss']:.6f} "
        f"last {rows[-1]['loss']:.6f}")
    if not last < first:
        raise AssertionError("the reconstruction loss from the replay buffer did not fall")
    result = hook["result"]
    if result is None or not np.isfinite(np.asarray(result)).all():
        raise AssertionError("degenerate or non-finite replay evaluation")
    curve = np.asarray(result[0])
    if len(curve) < COMPARE_STEPS:
        raise AssertionError(f"replay evaluation curve cut at {len(curve)} steps")
    snap = hook["params"]
    with torch.inference_mode():
        short = tuple(x[:, :COMPARE_STEPS + 2] for x in hook["batch"])
        pt = pack_transition_weights(snap.transition, latent, num_actions)
        pd = pack_decoder_weights(snap.decoder, latent)
        plain = _free_run_stats(
            snap, short, num_actions,
            transition_fn=lambda z, a: transition_plain(pt, z, a, dtype=bf16),
            decode_fn=lambda z: decode_plain(pd, z, dtype=bf16))[0].cpu().numpy()
    say(f"[replay] (d) evaluation pixel MSE, first {COMPARE_STEPS} steps: kernels "
        f"{np.array2string(curve[:COMPARE_STEPS], precision=6)}")
    say(f"[replay] (d)                                        plain   "
        f"{np.array2string(plain, precision=6)}")
    if not np.allclose(curve[:COMPARE_STEPS], plain, rtol=CURVE_RTOL, atol=CURVE_ATOL):
        raise AssertionError("the replay evaluation's curve disagrees with the plain path")

    # one iteration as the trainer runs it (stitch, copy, step) under the profiler
    step = trainer.make_train_step(cfg, cfg.horizon_max)
    holder, parts = {"state": state}, {}

    def one_iteration():
        t0 = time.perf_counter()
        host = ds.get_trajectories(cfg.batch_size, cfg.horizon_max)
        t1 = time.perf_counter()
        batch = to_device_batch(*host, ds.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        holder["state"] = step(holder["state"], batch, LossNoise(gen), 1.0, 1.0)[0]
        parts["stitch"], parts["copy"] = t1 - t0, t2 - t1

    one_iteration()
    wall, busy, by_name = profile_device(one_iteration)
    say(f"[replay] (d) one iteration at horizon {cfg.horizon_max}, B = {cfg.batch_size}, CF "
        f"on, under the profiler: {1e3 * wall:.2f} ms wall, card busy {1e3 * busy:.2f} ms "
        f"({100 * busy / wall:.1f}%); host stitch {1e3 * parts['stitch']:.3f} ms "
        f"({100 * parts['stitch'] / wall:.1f}%), copy {1e3 * parts['copy']:.3f} ms "
        f"({100 * parts['copy'] / wall:.1f}%)")
    print_top_kernels("replay", by_name, busy, n=6)
    return {"launches": launches, "ms_by_horizon": {h: float(np.mean(v)) for h, v in by_h.items()},
            "peak_gib": peak / 2**30, "rec": (first, last), "busy": busy / wall,
            "stitch_share": parts["stitch"] / wall, "copy_share": parts["copy"] / wall}


def replay_free_run(ds, model, latent, phase4) -> dict:
    """(e): the shipped bundle's free-run on the test split, launches held,
    the first steps against the plain path, the curves beside phase 4's."""
    num_actions = ds.binary_input_channels
    bf16 = torch.bfloat16
    kept = {}
    collect = ds.collect

    def keep(*args, **kwargs):
        kept["batch"] = collect(*args, **kwargs)
        return kept["batch"]

    ds.collect = keep
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        result = measure_prediction_mse(
            model, ds, batch_size=BATCH, timesteps=TIMESTEPS, use_training_set=False,
            make_plots=False, out_dir=tempfile.mkdtemp(prefix="chip_smoke_replay_mse_"),
            generator=torch.Generator(device="cuda").manual_seed(SEED + 40))
    finally:
        del ds.collect
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    say(f"[replay] (e) measure_prediction_mse of {BUNDLE} on the test split, B={BATCH} "
        f"T={TIMESTEPS}: {wall:.3f} s wall (stitch and copy included); launches {launches}")
    if launches != {"fused_transition": TIMESTEPS - 1, "fused_decode": TIMESTEPS - 2,
                    "int8_transition": 0}:
        raise AssertionError(f"the replay free-run did not run the kernels: {launches}")
    if result is None or not np.isfinite(np.asarray(result)).all():
        raise AssertionError("degenerate or non-finite replay free-run")
    mse, _, rew, _ = result
    if len(mse) < COMPARE_STEPS:
        raise AssertionError(f"replay free-run curve cut at {len(mse)} steps")
    pt = pack_transition_weights(model.transition, latent, num_actions)
    pd = pack_decoder_weights(model.decoder, latent)
    with torch.inference_mode():
        short = tuple(x[:, :COMPARE_STEPS + 2] for x in kept["batch"])
        plain = _free_run_stats(
            model, short, num_actions,
            transition_fn=lambda z, a: transition_plain(pt, z, a, dtype=bf16),
            decode_fn=lambda z: decode_plain(pd, z, dtype=bf16))[0].cpu().numpy()
    curve = np.asarray(mse[:COMPARE_STEPS])
    say(f"[replay] (e) pixel MSE, first {COMPARE_STEPS} steps: kernels "
        f"{np.array2string(curve, precision=6)}")
    say(f"[replay] (e)                             plain   "
        f"{np.array2string(plain, precision=6)}")
    if not np.allclose(curve, plain, rtol=CURVE_RTOL, atol=CURVE_ATOL):
        raise AssertionError("the replay free-run's curve disagrees with the plain path")
    dones = kept["batch"][2].float().mean().item()
    say(f"[replay] (e) curve length {len(mse)} (cut where every row has met a done; "
        f"{100 * dones:.1f}% of the batch's steps are dones)")
    for name, ours, theirs in (("pixel", mse, phase4[0]), ("reward", rew, phase4[1])):
        say(f"[replay] (e) {name} MSE at t+k, replay test split / phase 4's device-env "
            "batch: " + ", ".join(
                f"t+{k} {ours[k - 1]:.6g} / {theirs[k - 1]:.6g}"
                for k in REPLAY_CURVE_STEPS if k <= min(len(ours), len(theirs))))
    return {"launches": launches, "wall": wall, "batch": kept["batch"]}


def check_avi(path: str, n_frames: int, height: int, width: int):
    data = open(path, "rb").read()
    if not (path.endswith(".avi") and data[:4] == b"RIFF" and data[8:12] == b"AVI "
            and int.from_bytes(data[4:8], "little") == len(data) - 8):
        raise AssertionError(f"{path} is not an uncompressed AVI")
    avih = data.index(b"avih") + 8
    frames, w, h = (int.from_bytes(data[avih + o:avih + o + 4], "little")
                    for o in (16, 32, 36))
    chunks = data.count(b"00db")
    if (frames, w, h) != (n_frames, width, height) or chunks < 2 * n_frames:
        raise AssertionError(f"{path}: {frames} frames {w}x{h}, {chunks} chunks; expected "
                             f"{n_frames} frames {width}x{height}")
    return len(data)


def replay_backends():
    """(g): the host backends on this machine: allocation raises where a
    backend is absent (SC2 allocates and its env constructor raises, as in
    the JAX package); where gym imports, a CarRacing collect and one train
    step on the card."""
    try:
        import_gym()
        gym_error = None
    except ImportError as e:
        gym_error = e
        say(f"[replay] (g) import_gym() raised ImportError: {e}")
    for name in ("gym:CarRacing-v3", "atari", "centipede", "sc2_star_intruders"):
        try:
            ds = allocate_datasource(name, seed=SEED, device="cuda")
        except ImportError as e:
            say(f"[replay] (g) allocate_datasource({name!r}) raised ImportError: {e}")
            continue
        try:
            if name.startswith("sc2_"):
                try:
                    ds.make_env()
                except ImportError as e:
                    say(f"[replay] (g) allocate_datasource({name!r}) allocates; its env "
                        f"constructor raised ImportError: {e}")
                else:
                    raise AssertionError("an SC2 env was constructed")
            elif gym_error is not None:
                raise AssertionError(f"{name} allocated with no gym backend")
            elif name.startswith("gym:"):
                cfg = Config(env=name, seed=SEED, batch_size=4, horizon_min=3, horizon_max=3)
                gen = torch.Generator(device="cuda").manual_seed(SEED)
                st = trainer.init_train_state(cfg, ds.spec, gen)
                batch = ds.collect(cfg.batch_size, 3, generator=gen)
                st, m = trainer.make_train_step(cfg, 3)(st, batch, LossNoise(gen), 0.5, 0.0)
                say(f"[replay] (g) {name}: collect {tuple(batch[0].shape)} on the card, one "
                    f"train step loss {float(m['loss']):.6f}")
                if not np.isfinite(float(m["loss"])):
                    raise AssertionError(f"{name}: train step loss not finite")
            else:
                say(f"[replay] (g) {name} allocated (its backend is installed)")
        finally:
            ds.close()


def replay_phase(model, latent, phase4, phase6_ms, cli_videos) -> dict:
    """The eighth main path: a host actor's replay buffer feeds training and
    the free-run on the card.  Returns the kernels' launch counts of (d) and
    (e) and the phase's numbers."""
    t_phase = time.perf_counter()
    # (a) the native library, built from the checkout's sources into a fresh
    # directory so that the build is timed whatever ran before
    build_dir = native.BUILD_DIR
    native.BUILD_DIR = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_native_"))
    try:
        t0 = time.perf_counter()
        fresh = native.build()
        native_s = time.perf_counter() - t0
    finally:
        native.BUILD_DIR = build_dir
    say(f"[replay] (a) {native.compiler()}: {fresh.name} ({fresh.stat().st_size} B) built "
        f"in {native_s:.3f} s; loaded: {pathlib.Path(native.library()._name).name}")

    # (b) ingest with 1 actor, then the datasource of the rest with 2
    one = replay_datasource(1, SEED + 50)
    try:
        rate1 = ingest(one, REPLAY_INGEST_S)
    finally:
        one.close()
    ds = replay_datasource(REPLAY_ACTORS, SEED + 60)
    try:
        rate2 = ingest(ds, REPLAY_INGEST_S)
        for n, r in ((1, rate1), (REPLAY_ACTORS, rate2)):
            say(f"[replay] (b) {n} actor(s) playing {ENV} on the host: {r['episodes']} "
                f"episodes, {r['frames']} frames in {r['s']:.3f} s: "
                f"{r['episodes_per_s']:.2f} episodes/s, {r['frames_per_s']:.1f} frames/s")
        if rate1["episodes"] < 1 or rate2["episodes"] < 1:
            raise AssertionError("no episode reached the replay buffer")
        ds.collect(1, 2, training=False)     # waits for both splits to fill
        say(f"[replay] (b) buffer: {ds.buffer.size(True)} train / {ds.buffer.size(False)} "
            f"test episodes")

        # (c) batches
        batches = replay_batches(ds)

        # (d) training from the buffer, the actors playing
        trained = replay_train(ds, latent, phase6_ms)

        # (e) the shipped bundle on the test split
        served = replay_free_run(ds, model, latent, phase4)

        # (f) videos: the native AVI writer on this machine
        frames = served["batch"][0][0, :REPLAY_VIDEO_FRAMES].cpu().numpy()
        vid = Video(os.path.join(tempfile.mkdtemp(prefix="chip_smoke_avi_"), "replay.mp4"))
        for f in frames:
            vid.write_frame(f, resize_to=(128, 128))
        path = vid.finish()
        size = check_avi(path, len(frames), 128, 128)
        say(f"[replay] (f) Video.finish wrote {os.path.basename(path)}: {size} B, RIFF/AVI, "
            f"{len(frames)} frames 128x128; phase 9's evaluation videos: {cli_videos}")
        if not cli_videos or not all(v.endswith(".avi") for v in cli_videos):
            raise AssertionError(f"phase 9's videos are not .avi files: {cli_videos}")

        # (g) the host backends of this machine
        replay_backends()
    finally:
        # (h) shutdown
        ds.close()
    alive = [a for a in ds.actors + one.actors if a.is_alive()]
    threads = [t.name for t in threading.enumerate() if t.name.endswith("(_run)")]
    say(f"[replay] (h) close(): {len(alive)} actors alive, actor threads left {threads}")
    if alive or threads:
        raise AssertionError("an actor thread outlived close()")
    wall = time.perf_counter() - t_phase
    say(f"[replay] phase wall {wall:.3f} s")
    return {"launches": add_launches(trained["launches"], served["launches"]),
            "ingest": (rate1, rate2), "batches": batches, "train": trained,
            "native_build_s": native_s, "wall": wall}

# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# the device mesh, the pipeline and the spatial transition
# ---------------------------------------------------------------------------

MESH_ITERS = 12            # horizon 3 -> 10; the evaluation hook before the last step
MESH_BATCH = 32
MESH_EVAL_TIMESTEPS = 30
MESH_STEP_ITERS = 10       # (b): iterations timed at each route
MESH_STEP_HORIZON = 6
PIPE_MICRO = (1, 2, 4)
PIPE_P_ATOL = 1e-5         # f32 convs with TF32 off, summed in other orders
MESH_DEVICE = "cuda"
PIPE_DEVICES = ("cuda:0",) * 3
# (a) runs the command line in its own process under this runner, which
# prints every iteration's metrics and the kernels' launch counts
MESH_RUNNER = """
import json, sys
from scmgan_tpu_torch.cli import main as cli
from scmgan_tpu_torch.ops.kernels import int8_transition as i8
from scmgan_tpu_torch.ops.kernels.fused_decoder import fused_decode
from scmgan_tpu_torch.ops.kernels.fused_transition import fused_transition
from scmgan_tpu_torch.train import trainer
losses, train = [], trainer.train
def recording(*args, log_fn=None, **kw):
    def log(i, metrics):
        losses.append({k: float(v) for k, v in metrics.items()})
        log_fn(i, metrics)
    return train(*args, log_fn=log, **kw)
trainer.train = recording
for f in (fused_transition, fused_decode, i8.int8_transition):
    f.launches = 0
cli.main(sys.argv[1:])
print("MESH_RESULT " + json.dumps({"losses": losses, "launches": {
    "fused_transition": fused_transition.launches, "fused_decode": fused_decode.launches,
    "int8_transition": i8.int8_transition.launches}}))
"""


def run_mesh_clis(runs):
    """``python -m scmgan_tpu_torch argv`` under ``MESH_RUNNER`` for each
    (label, argv), the processes started together: each one's
    per-iteration metrics and launches, and the wall seconds of all."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", MESH_RUNNER, *argv], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _, argv in runs]
    results = []
    for (label, argv), proc in zip(runs, procs):
        stdout, stderr = proc.communicate(timeout=300)
        line = next((l for l in stdout.splitlines() if l.startswith("MESH_RESULT ")), None)
        if proc.returncode != 0 or line is None:
            say(stdout[-2000:])
            say(stderr[-3000:])
            raise AssertionError(f"mesh ({label}): python -m scmgan_tpu_torch failed")
        res = json.loads(line[len("MESH_RESULT "):])
        say(f"[mesh] ({label}) python -m scmgan_tpu_torch {' '.join(argv)}: launches "
            f"{res['launches']}")
        results.append(res)
    return results, time.perf_counter() - t0


def mesh_step_routes(ds):
    """(b): the sharded step at (1, 1) against the plain step, from one
    state, batch and draws, ms per iteration and peak memory each.  Each
    route's step is built once and called every iteration, as ``train``
    builds one step per horizon."""
    cfg = Config(env=ENV, seed=SEED, enable_disentanglement_loss=True,
                 enable_action_control_loss=True, counterfactual_horizon=2)
    mesh = make_mesh((1, 1), device_type=MESH_DEVICE)
    routes = {"plain": None, "sharded (1, 1)": mesh}
    runs = {}
    for route, rules in routes.items():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        runs[route] = {"gen": gen, "state": trainer.init_train_state(cfg, ds.spec, gen),
                       "step": trainer.make_train_step(cfg, MESH_STEP_HORIZON, rules),
                       "losses": [], "ms": [], "peak": 0}
    # the routes alternate step by step, so that the shared host's clock
    # treats them alike; each starts from its own generator of one seed
    for i in range(MESH_STEP_ITERS):
        for route, r in runs.items():
            batch = ds.collect(cfg.batch_size, MESH_STEP_HORIZON, generator=r["gen"])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r["state"], metrics = r["step"](r["state"], batch, LossNoise(r["gen"]), 0.5,
                                            float(i % 2))
            torch.cuda.synchronize()
            r["ms"].append(1e3 * (time.perf_counter() - t0))
            r["peak"] = max(r["peak"], torch.cuda.max_memory_allocated())
            r["losses"].append({k: float(v) for k, v in metrics.items()})
    out = {}
    for route, r in runs.items():
        state = r["state"]
        params = state.params if state.shardings is None else gather_pytree(
            state.params, state.shardings)
        out[route] = {"losses": r["losses"], "params": flat_params(params),
                      "ms": float(np.mean(r["ms"][1:])), "first_ms": r["ms"][0],
                      "peak_gib": r["peak"] / 2**30}
        say(f"[mesh] (b) {route} step, minipacman B = {cfg.batch_size}, horizon "
            f"{MESH_STEP_HORIZON}, {cfg.compute_dtype}: {out[route]['ms']:.3f} ms per "
            f"iteration (mean of {MESH_STEP_ITERS - 1} after the first, "
            f"{out[route]['first_ms']:.3f}; the routes alternate); peak during its steps "
            f"{out[route]['peak_gib']:.3f} GiB (both states resident)")
    plain, sharded = out["plain"], out["sharded (1, 1)"]
    if plain["losses"] != sharded["losses"]:
        raise AssertionError(f"mesh (b): the (1, 1) step's losses differ: "
                             f"{plain['losses'][-1]} vs {sharded['losses'][-1]}")
    for k, v in plain["params"].items():
        if not torch.equal(v, sharded["params"][k]):
            raise AssertionError(f"mesh (b): the (1, 1) step's {k} differs")
    return mesh, out


def mesh_pipeline_and_spatial(model, mesh, rng, num_actions):
    """(c) the pipeline over three streams of one card and (d) the spatial
    transition on the one-process ring, against the unsharded transition."""
    b = BATCH
    z, a = binary_latents(rng, b), onehot_actions(rng, b, num_actions)
    params = model.transition
    out = {}
    with no_tf32():
        probs = transition(params, z, a, train=True, deterministic=True)
        bits = transition(params, z, a, train=False)
        near = (probs - 0.5).abs() <= PIPE_P_ATOL
        for n in PIPE_MICRO:
            got = pipeline_transition(params, z, a, PIPE_DEVICES, n_micro=n)
            got_p = pipeline_transition(params, z, a, PIPE_DEVICES, n_micro=n, sample=False)
            p_err = float((got_p - probs).abs().max())
            flips = got != bits
            if p_err > PIPE_P_ATOL or bool((flips & ~near).any()):
                raise AssertionError(f"mesh (c): pipeline n_micro={n}: max |dp| {p_err:.3e}, "
                                     f"{int(flips.sum())} flipped bits, "
                                     f"{int((flips & ~near).sum())} away from p = 0.5")
            ms = cuda_ms(lambda n=n: pipeline_transition(params, z, a, PIPE_DEVICES,
                                                         n_micro=n), iters=3, warmup=1)
            out[n] = {"ms": ms, "max_abs_dp": p_err, "flips": int(flips.sum())}
            say(f"[mesh] (c) pipeline_transition n_micro={n} on {list(PIPE_DEVICES)}: "
                f"max |p - p_ref| {p_err:.3e}, {int(flips.sum())} bits flipped "
                f"({int(near.sum())} of {near.numel()} within {PIPE_P_ATOL} of 0.5); "
                f"{ms:.3f} ms per call")
        plain_ms = cuda_ms(lambda: transition(params, z, a, train=False), iters=3, warmup=1)
        spatial = spatial_transition(params, z, a, mesh)
        if not torch.equal(spatial, bits):
            raise AssertionError(f"mesh (d): the spatial transition differs in "
                                 f"{int((spatial != bits).sum())} bits")
        say(f"[mesh] (d) spatial_transition on the one-process ring (B = {b}, "
            f"{z.shape[1]}x{z.shape[2]}): bit-equal to the unsharded transition")
    pt = pack_transition_weights(params, z.shape[-1], num_actions)
    kernel_ms = cuda_ms(lambda: fused_transition(pt, z, a))
    say(f"[mesh] (c) per call at B = {b}, 64x64: unsharded cuDNN transition (f32) "
        f"{plain_ms:.3f} ms, fused_transition kernel (bf16) {kernel_ms:.4f} ms; pipeline "
        + ", ".join(f"n_micro={n} {r['ms']:.3f} ms" for n, r in out.items()))
    return {"pipeline": out, "plain_ms": plain_ms, "kernel_ms": kernel_ms}


def mesh_phase(model, ds):
    """The ninth main path: the command line on a device mesh, the sharded
    step, the pipeline and the spatial transition on one card."""
    t_phase = time.perf_counter()
    out = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    argv = ["--env", ENV, "--seed", str(SEED), "--batch-size", str(MESH_BATCH), "--train-iters",
            str(MESH_ITERS), "--iters-per-video", str(MESH_ITERS), "--eval-batch-size",
            str(BATCH), "--eval-timesteps", str(MESH_EVAL_TIMESTEPS), "--no-videos"]
    # (a) --mesh 1x1 (a one-process NCCL group) against the same run without it
    (mesh_res, plain_res), wall = run_mesh_clis(
        [("--mesh 1x1", [*argv, "--mesh", "1x1", "--out-dir", f"{out}/mesh"]),
         ("no mesh", [*argv, "--out-dir", f"{out}/plain"])])
    if len(mesh_res["losses"]) != MESH_ITERS:
        raise AssertionError(f"mesh (a): {len(mesh_res['losses'])} iterations logged")
    worst = 0.0
    for i, (m, p) in enumerate(zip(mesh_res["losses"], plain_res["losses"])):
        for k in p:
            rel = abs(m[k] - p[k]) / max(abs(p[k]), 1e-30)
            worst = max(worst, rel)
            if rel > 1e-6 or not np.isfinite(m[k]):
                raise AssertionError(f"mesh (a): iteration {i + 1} {k}: {m[k]} vs {p[k]}")
    want = evaluate_launches(cli_config(argv), videos=False)
    check_launches("mesh 1x1", mesh_res["launches"], want)
    check_launches("no mesh", plain_res["launches"], want)
    state = ckpt.load_train_state(f"{out}/mesh", trainer.init_train_state(
        cli_config(argv), ds.spec, torch.Generator(device="cuda").manual_seed(0)))
    if state.step != MESH_ITERS or state.shardings is not None:
        raise AssertionError(f"mesh (a): the checkpoint loads at step {state.step}")
    say(f"[mesh] (a) {MESH_ITERS} iterations, minipacman B = {MESH_BATCH} at full width: losses of "
        f"the --mesh 1x1 run equal the plain run's (worst relative difference {worst:.3e}); "
        f"final loss {mesh_res['losses'][-1]['loss']:.6f}; checkpoint at step {state.step} "
        f"loads unsharded; both processes (run together) {wall:.3f} s wall")
    mesh, routes = mesh_step_routes(ds)
    try:
        pipe = mesh_pipeline_and_spatial(model, mesh, np.random.default_rng(SEED + 13),
                                         ds.binary_input_channels)
    finally:
        distributed.shutdown()
    say(f"[mesh] phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": mesh_res["launches"], "routes": routes, "pipe": pipe}



# ---------------------------------------------------------------------------
# every hidden width and action count: both transition kernels at the widths
# no shipped model has, a student made at h96, centipede's 18 actions
# ---------------------------------------------------------------------------

# (latent, hidden, actions): the kernels' multiples of 16 that no shipped
# model has (16, 32, 96, 112), widths between them (50, 104: run at the next
# multiple on zero-padded operands), ALE's full action set at the teacher's
# width, widths past one 128-channel output tile (144, 200, 256: two N
# tiles, the int8 K split into 128-channel segments), and latents 4, 8, 32
# and 64 (conv1's K and the head's N zero-padded to multiples of 16).
SHAPE_CASES = ((16, 16, 5), (16, 32, 5), (16, 50, 5), (16, 96, 5), (16, 104, 5), (16, 112, 5),
               (16, 128, 18), (16, 144, 5), (8, 200, 5), (16, 256, 4), (4, 64, 5), (8, 128, 5),
               (32, 128, 5), (64, 256, 18))
# (batch, side): the free-run's and the MPC beam's shapes
SHAPE_BATCHES = ((BATCH, 64), (MPC_GRID_EPISODES * 64, 16))
# (a) the decoder at other latents (intermediate 4L), 1 and 3 colours
SHAPE_DECODE_LATENTS = (4, 8, 32, 64)
SHAPE_DECODE_COLORS = (1, 3)
# phase 7's rows at these (latent, hidden) (5 actions, B = 100, 64x64), and
# the decoder's at these latents
SHAPE_TIME_CASES = ((16, 16), (16, 32), (16, 50), (16, 96), (16, 104), (16, 112), (16, 144),
                    (16, 256), (8, 128), (32, 128))
DECODE_TIME_LATENTS = (8, 32, 64)
# (b) a student at h96 from minipacman_cf, made as phase 11 (c) makes one but
# with 20 iterations: its gate is printed, not held
SHAPES_DISTILL_ARGV = ["--env", ENV, "--teacher", BUNDLE, "--hidden", "96", "--iters", "20",
                       "--qat-from", "0.5", "--qat-recal", "10", "--eval-seeds", "1"]
# (d) a latent-8 gridworld model (tests/test_train.py's configuration)
# trained a few iterations, then its free-run and one plan of each kernel
LATENT8_ITERS = 4
# (e) a random minipacman model at latent 32, hidden 256, free-run at full
# size
WIDE_MODEL = (32, 256)
# (c) centipede on a stand-in ALE: a few training iterations at the Config's
# width with the evaluation hook, then the evaluation
CENTIPEDE_ARGV = ["--env", "centipede", "--train-iters", "4", "--iters-per-video", "4",
                  "--eval-batch-size", str(BATCH), "--eval-timesteps", "30", "--no-videos"]
CENTIPEDE_EPISODE_STEPS = 200


class StandInALE:
    """A stand-in for ``atari_py`` (the card's machine has no ALE), put in
    ``sys.modules`` for phase 14 (c): a deterministic emulator whose screen
    holds a red band falling one row a frame and a green column that the
    actions move, episodes of CENTIPEDE_EPISODE_STEPS steps (two acts a
    step), a reward for FIRE every third act."""

    class ALEInterface:
        def __init__(self):
            self.t, self.x = 0, 76

        def loadROM(self, path):
            self.rom = path

        def reset_game(self):
            self.t, self.x = 0, 76

        def act(self, a):
            self.t += 1
            self.x = (self.x + 4 * (a % 3 - 1)) % 152
            return float(a == 1 and self.t % 3 == 0)

        def getScreenRGB2(self):
            frame = np.zeros((210, 160, 3), np.uint8)
            y = self.t % 200
            frame[y:y + 10, :, 0] = 255
            frame[:, self.x:self.x + 8, 1] = 255
            return frame

        def game_over(self):
            return self.t >= 2 * CENTIPEDE_EPISODE_STEPS

        def lives(self):
            return 3

    @staticmethod
    def get_game_path(name):
        return f"/roms/{name}.bin"


def random_transition(hidden, num_actions, seed, latent=16):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return init_transition(gen, latent, num_actions, hidden=hidden)


def shapes_kernel_checks(model, rng):
    """(a) both transition kernels against their plain versions at every
    case of SHAPE_CASES and shape of SHAPE_BATCHES: the bf16 kernel's two
    heads, the int8 kernel in a calibrated packing (``calibrated_qt``) and
    the three static ones; the decoder at SHAPE_DECODE_LATENTS and
    SHAPE_DECODE_COLORS; each call's launch counted."""
    checks, int8_checks, d_errs = [], [], []

    def counted(label, want, fn):
        before = counters()
        out = fn()
        moved = {k: v - before[k] for k, v in counters().items()}
        if moved != {**{k: 0 for k in moved}, **want}:
            raise AssertionError(f"shapes (a): {label}: launches {moved}, the checks imply "
                                 f"{want}")
        return out

    for lat, hidden, acts in SHAPE_CASES:
        params = random_transition(hidden, acts, SEED + hidden + acts
                                   + (0 if lat == 16 else 1000 * lat), lat)
        pt = pack_transition_weights(params, lat, acts)
        qt = calibrated_qt(model._replace(transition=params),
                           binary_latents(rng, 1, latent=lat), acts)
        packings = {"calibrated": (qt.packed, "logit"),
                    **{f"static {order}": (pack(params), "sigmoid")
                       for order, pack in INT8_PACKINGS.items()}}
        for b, hw in SHAPE_BATCHES:
            z, a = binary_latents(rng, b, hw, lat), onehot_actions(rng, b, acts)
            label = f"latent {lat}, hidden {hidden}, {acts} actions, {hw}x{hw}"
            checks.append(counted(label, {"fused_transition": 2},
                                  lambda: check_transition(pt, z, a, lat, f" ({label})")))
            for name, (packed, head) in packings.items():
                int8_checks.append(counted(label, {"int8_transition": 2}, lambda: check_int8(
                    f"l{lat} h{hidden} a{acts} {name}", packed, z.to(torch.int8), a, head)))
    for lat in SHAPE_DECODE_LATENTS:
        for color in SHAPE_DECODE_COLORS:
            gen = torch.Generator(device="cuda").manual_seed(SEED + 100 * lat + color)
            pd = pack_decoder_weights(init_decoder(gen, lat, color), lat)
            for b, hw in SHAPE_BATCHES:
                z = binary_latents(rng, b, hw, lat)
                label = f"latent {lat}, {color} colour(s), {hw}x{hw}"
                d_errs.append(counted(label, {"fused_decode": 1},
                                      lambda: check_decoder(pd, z, f" ({label})")))
    return checks, int8_checks, d_errs


def free_run_against_plain(tag, model, ds, num_actions, out_dir):
    """``measure_prediction_mse`` at B = BATCH x TIMESTEPS through the
    kernels, its launches as the path implies, and its first COMPARE_STEPS
    steps against the plain path on the same batch (phase 4's check).
    Returns the launches, the wall seconds and the peak device memory."""
    latent = model.transition["conv6"]["w"].shape[-1]
    pt = pack_transition_weights(model.transition, latent, num_actions)
    pd = pack_decoder_weights(model.decoder, latent)
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = measure_prediction_mse(
        model, ds, batch_size=BATCH, timesteps=TIMESTEPS, make_plots=False, out_dir=out_dir,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 16))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if result is None:
        raise AssertionError(f"{tag}: degenerate trajectory batch")
    check_launches(f"{tag} free-run", launches, {"fused_transition": TIMESTEPS - 1,
                                                 "fused_decode": TIMESTEPS - 2,
                                                 "int8_transition": 0})
    main_curve = np.asarray(result[0][:COMPARE_STEPS])
    with torch.inference_mode():
        batch = ds.collect(BATCH, TIMESTEPS,
                           generator=torch.Generator(device="cuda").manual_seed(SEED + 16))
        short = tuple(x[:, :COMPARE_STEPS + 2] for x in batch)
        k_curve = _free_run_stats(model, short, num_actions)[0].cpu().numpy()
        p_curve = _free_run_stats(
            model, short, num_actions,
            transition_fn=lambda z, a: transition_plain(pt, z, a, dtype=torch.bfloat16),
            decode_fn=lambda z: decode_plain(pd, z, dtype=torch.bfloat16))[0].cpu().numpy()
    say(f"[shapes] {tag} measure_prediction_mse B={BATCH} T={TIMESTEPS}: {wall:.3f} s, peak "
        f"{peak:.2f} GiB, launches {launches}; pixel MSE first {result[0][0]:.6g} last "
        f"{result[0][-1]:.6g}")
    say(f"[shapes] {tag} pixel MSE, first {COMPARE_STEPS} steps: main path "
        f"{np.array2string(main_curve, precision=6)}")
    say(f"[shapes] {tag}                                plain path "
        f"{np.array2string(p_curve, precision=6)}")
    if not np.isfinite(np.array(result)).all():
        raise AssertionError(f"{tag}: non-finite MSE curves")
    if not np.allclose(k_curve, main_curve, rtol=1e-5, atol=1e-7):
        raise AssertionError(f"{tag}: the re-collected batch does not reproduce the main path")
    if not np.allclose(main_curve, p_curve, rtol=CURVE_RTOL, atol=CURVE_ATOL):
        raise AssertionError(f"{tag}: the free-run disagrees with the plain path")
    return launches, wall, peak


def latent8_gridworld():
    """(d) a latent-8 gridworld model (tests/test_train.py's configuration)
    trained LATENT8_ITERS iterations through ``trainer.train``, its
    free-run on the kernels against the plain path, one bf16 and one int8
    plan at the records' reference beam."""
    ds = allocate_datasource("gridworld", seed=SEED, device="cuda")
    acts = ds.binary_input_channels
    cfg = Config(env="gridworld", seed=SEED, latent_dim=8, batch_size=4,
                 train_iters=LATENT8_ITERS, iters_per_video=LATENT8_ITERS, horizon_min=3,
                 horizon_max=5, learning_rate=1e-3)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    losses = []
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.train(cfg, ds, trainer.init_train_state(cfg, ds.spec, gen),
                          log_fn=lambda it, m: losses.append(float(m["loss"])), generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check_launches("shapes (d) train", counters(), {k: 0 for k in counters()})
    model = state.params
    if model.transition["conv6"]["w"].shape[-1] != 8 or not np.isfinite(losses).all():
        raise AssertionError(f"shapes (d): not a latent-8 model, or losses {losses}")
    say(f"[shapes] (d) gridworld at latent {cfg.latent_dim}, hidden {cfg.hidden_dim}: "
        f"{LATENT8_ITERS} iterations in {train_s:.3f} s, losses {np.round(losses, 5).tolist()}")
    run_launches, _, _ = free_run_against_plain(
        "(d)", model, ds, acts, tempfile.mkdtemp(prefix="chip_smoke_latent8_"))
    z = seed_latents(model, ds, 1, SEED)
    beam = dict(lookahead=MPC_LOOKAHEAD, rollout_depth=MPC_DEPTH)
    qt = calibrated_qt(model, z, acts)
    plans, plan_launches = {}, []
    for name, planner, counter in (
            ("bf16", make_planner(model, acts, **beam), "fused_transition"),
            ("int8", make_planner(model, acts, use_int8=True, qt=qt, **beam), "int8_transition")):
        zero_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        action, scores = planner(z)
        torch.cuda.synchronize()
        plans[name] = (time.perf_counter() - t0, action)
        plan_launches.append(counters())
        check_launches(f"shapes (d) {name} plan", counters(),
                       {**{k: 0 for k in counters()}, counter: MPC_DEPTH + 1})
        if scores.shape != (acts,) or not torch.isfinite(scores).all():
            raise AssertionError(f"shapes (d): the {name} plan's scores are not finite")
    say(f"[shapes] (d) one plan at lookahead {MPC_LOOKAHEAD}, depth {MPC_DEPTH} "
        f"({acts ** (MPC_LOOKAHEAD + 1)} beams of {z.shape[1]}x{z.shape[2]}x{z.shape[3]} "
        f"latents): " + ", ".join(f"{k} {s:.3f} s (action {act})"
                                  for k, (s, act) in plans.items()))
    return {"launches": add_launches(run_launches, *plan_launches), "train_s": train_s,
            "plan_s": {k: v[0] for k, v in plans.items()}}


def wide_model_free_run(ds):
    """(e) a random minipacman model at WIDE_MODEL's latent and hidden
    widths free-run at full size through the kernels, against the plain
    path, with its peak memory."""
    latent, hidden = WIDE_MODEL
    spec, acts = ds.spec, ds.binary_input_channels
    model = init_world_model(torch.Generator(device="cuda").manual_seed(SEED + 32), latent,
                             acts, spec.num_rewards, spec.channels, spec.channels,
                             hidden=hidden, img_size=spec.height)
    launches, wall, peak = free_run_against_plain(
        f"(e) latent {latent}, hidden {hidden}", model, ds, acts,
        tempfile.mkdtemp(prefix="chip_smoke_wide_"))
    return {"launches": launches, "wall": wall, "peak_gib": peak}


def student_h96():
    """(b) ``distill_student --hidden 96`` in this process (its launches
    counted), at PyTorch's default precision as the command runs."""
    out = tempfile.mkdtemp(prefix="chip_smoke_student_h96_")
    argv = [*SHAPES_DISTILL_ARGV, *GATE_ARGV, "--out", out]
    zero_counters()
    torch.cuda.synchronize()
    log = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(log), pytorch_default_precision():
            res = distill_student.main(argv)
    except BaseException:
        say(log.getvalue()[-3000:])
        raise
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    run = res["run"]
    with open(os.path.join(out, "fidelity.json")) as f:
        fid = json.load(f)
    zero = {k: 0 for k in counters()}
    say(f"[shapes] (b) distill_student {' '.join(argv)}: {wall:.3f} s in this process; "
        f"stage seconds {run['seconds']}; launches {launches}; BCE first {run['bce'][0]:.5f} "
        f"last {run['bce'][-1]:.5f}; the gate (not held after "
        f"{SHAPES_DISTILL_ARGV[SHAPES_DISTILL_ARGV.index('--iters') + 1]} iterations): "
        f"mse10_delta_pct {fid['mse10_delta_pct']:.4f}, int8_delta_pct at t+10 "
        f"{fid['int8_delta_pct']['10']:.4f}, within_1pct {fid['within_1pct']}")
    if fid["hidden"] != 96 or res["student"]["conv2"]["w"].shape[-1] != 96:
        raise AssertionError("shapes (b): the student is not 96 wide")
    if run["launches"] != {"distill": zero, "fidelity": gate_launches(1)} \
            or launches != gate_launches(1):
        raise AssertionError(f"shapes (b): launches {run['launches']}, the run implies "
                             f"{gate_launches(1)} in its gate")
    if not np.isfinite(run["bce"] + [v for k in ("teacher_mse", "student_int8_mse")
                                     for v in fid[k].values()]).all():
        raise AssertionError("shapes (b): a non-finite loss or gate MSE")
    return {"wall": wall, "launches": launches, "fidelity": fid}


def centipede_run():
    """(c) centipede's 18 actions through the command line on the stand-in
    ALE: training with its evaluation hook, ``--evaluate``, the free-run's
    first steps against the plain path, one plan at the reference beam."""
    saved = sys.modules.get("atari_py")
    sys.modules["atari_py"] = StandInALE
    try:
        out = tempfile.mkdtemp(prefix="chip_smoke_centipede_")
        argv = [*CENTIPEDE_ARGV, "--seed", str(SEED), "--out-dir", out]
        cfg = cli_config(argv)
        _, train_launches, train_wall = run_cli("shapes (c): centipede train", argv)
        n_evals = sum(1 for i in range(cfg.start_iter, cfg.train_iters + 1)
                      if i % cfg.iters_per_video == 0)
        check_launches("shapes (c) train", train_launches, {
            k: n_evals * v for k, v in evaluate_launches(cfg, videos=False).items()})
        eval_argv = [*CENTIPEDE_ARGV, "--evaluate", "--evaluations", "0", "--load-from", out,
                     "--seed", str(SEED), "--out-dir", tempfile.mkdtemp(prefix="chip_smoke_cent_")]
        res, eval_launches, eval_wall = run_cli("shapes (c): centipede --evaluate", eval_argv)
        check_launches("shapes (c) evaluate", eval_launches,
                       evaluate_launches(cli_config(eval_argv), videos=False))
        curve = np.asarray(res["evaluate"][0])
        model = res["state"].params
        acts = model.transition["conv1"]["w"].shape[2] - cfg.latent_dim
        if acts != 18 or not np.isfinite(res["evaluate"]).all():
            raise AssertionError(f"shapes (c): {acts} actions, or a non-finite curve")

        ds = allocate_datasource("centipede", seed=SEED, device="cuda")
        try:
            pt = pack_transition_weights(model.transition, cfg.latent_dim, acts)
            pd = pack_decoder_weights(model.decoder, cfg.latent_dim)
            gen = torch.Generator(device="cuda").manual_seed(SEED)
            with torch.inference_mode():
                # one frame past the window: a stitched clip's last step is
                # done, and masked
                batch = ds.collect(BATCH, COMPARE_STEPS + 3, generator=gen)
                k_curve = _free_run_stats(model, batch, acts)[0][:COMPARE_STEPS].cpu().numpy()
                p_curve = _free_run_stats(
                    model, batch, acts,
                    transition_fn=lambda z, a: transition_plain(pt, z, a, dtype=torch.bfloat16),
                    decode_fn=lambda z: decode_plain(pd, z, dtype=torch.bfloat16)
                )[0][:COMPARE_STEPS].cpu().numpy()
            z = seed_latents(model, ds, 1, SEED)
        finally:
            ds.close()
        say(f"[shapes] (c) centipede ({acts} actions, {z.shape[1]}x{z.shape[2]}, hidden "
            f"{cfg.hidden_dim}): train {train_wall:.3f} s, --evaluate {eval_wall:.3f} s; "
            f"evaluation pixel MSE first {curve[0]:.6g} last {curve[-1]:.6g}")
        say(f"[shapes] (c) free-run pixel MSE, first {COMPARE_STEPS} steps: kernels "
            f"{np.array2string(k_curve, precision=6)}")
        say(f"[shapes] (c)                                        plain   "
            f"{np.array2string(p_curve, precision=6)}")
        if not np.allclose(k_curve, p_curve, rtol=CURVE_RTOL, atol=CURVE_ATOL):
            raise AssertionError("shapes (c): the centipede free-run disagrees with the plain path")

        planner = make_planner(model, acts, lookahead=MPC_LOOKAHEAD, rollout_depth=MPC_DEPTH)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters()
        t0 = time.perf_counter()
        action, scores = planner(z)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        plan_launches = counters()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        beams = acts ** (MPC_LOOKAHEAD + 1)
        say(f"[shapes] (c) one plan at lookahead {MPC_LOOKAHEAD}, depth {MPC_DEPTH} ({beams} "
            f"beams of {z.shape[1]}x{z.shape[2]} latents): {plan_s:.3f} s, peak "
            f"{peak:.2f} GiB; action {action}, scores finite "
            f"{bool(torch.isfinite(scores).all())}; launches {plan_launches}")
        want = {"fused_transition": MPC_DEPTH + 1, "fused_decode": 0, "int8_transition": 0}
        check_launches("shapes (c) plan", plan_launches, want)
        if scores.shape != (acts,) or not torch.isfinite(scores).all():
            raise AssertionError("shapes (c): the plan's scores are not finite")
    finally:
        if saved is None:
            sys.modules.pop("atari_py", None)
        else:
            sys.modules["atari_py"] = saved
    return {"launches": add_launches(train_launches, eval_launches, plan_launches),
            "plan_s": plan_s, "peak_gib": peak, "walls": (train_wall, eval_wall)}


def shapes_phase(model, ds):
    """Every model shape on the card: (a) the three kernels against their
    plain versions at SHAPE_CASES and SHAPE_DECODE_LATENTS; (b) a student
    made at h96; (c) centipede's 18 actions; (d) a latent-8 gridworld model
    trained, free-run and planned; (e) a latent-32, hidden-256 model's
    free-run.  Returns the launches of (b)-(e), the kernel checks and the
    walls."""
    t_phase = time.perf_counter()
    checks, int8_checks, d_errs = shapes_kernel_checks(model, np.random.default_rng(SEED + 15))
    t_checks = time.perf_counter() - t_phase
    made = student_h96()
    cent = centipede_run()
    t0 = time.perf_counter()
    small = latent8_gridworld()
    t_small = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide = wide_model_free_run(ds)
    t_wide = time.perf_counter() - t0
    walls = {"checks": t_checks, "student_h96": made["wall"], "centipede_plan": cent["plan_s"],
             "latent8": t_small, "wide": t_wide, "phase": time.perf_counter() - t_phase}
    say("[shapes] wall seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))
    return {"launches": add_launches(made["launches"], cent["launches"], small["launches"],
                                     wide["launches"]),
            "checks": checks, "int8_checks": int8_checks, "d_errs": d_errs, "walls": walls,
            "plan_s": cent["plan_s"], "peak_gib": cent["peak_gib"],
            "wide_peak_gib": wide["peak_gib"]}


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    card = card_line()
    say(card)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f"  torch {torch.__version__} cuda {torch.version.cuda}"
        f"  cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
        f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    build_s = time.perf_counter() - t0
    lib = _build.library()
    say(f"[build] {lib_path.name} in {build_s:.2f} s")
    smem = {f"conv3x3_wgmma<{n},": lib.scm_transition_smem(n) for n in N_TILES}
    smem.update({f"conv3x3_s8<{n},": lib.scm_int8_smem(n) for n in N_TILES})
    # the decoder's at latent 16 (hidden 64), and at latent 32 and 64
    smem.update({f"decode_kernel<{np_}>": lib.scm_decode_smem(16, 16 * np_)
                 for np_ in (1, 2, 3, 4)})
    smem["decode_kernel<0>"] = max(lib.scm_decode_smem(lp, 4 * lp) for lp in (32, 64))
    for r in _build.ptxas_report():
        dyn = next((v for k, v in smem.items() if r["kernel"].startswith(k)), None)
        say(f"[build] {r['kernel']}: {r['registers']} registers, shared "
            f"{r['smem_static']} B static" + (f" + {dyn} B dynamic" if dyn else "")
            + f", spill {r['spill_bytes']} B")

    # 3. kernels against their plain versions, at B = 8 and at the main
    # paths' B = 100
    model = load_model(BUNDLE, device="cuda")
    student = load_pytree(f"{STUDENT}/model-transition.npz", "cuda")
    latent = model.encoder["conv4"]["w"].shape[-1]
    ds = allocate_datasource(ENV, seed=SEED, device="cuda")
    num_actions = ds.binary_input_channels
    pt = pack_transition_weights(model.transition, latent, num_actions)
    pts = pack_transition_weights(student, latent, num_actions)
    pd = pack_decoder_weights(model.decoder, latent)
    qt = calibrate_student(model, student, ds, SEED)
    int8_packings = {   # TPU kernel whose function each packing computes
        "transition_int8_v2": (qt.packed, "logit"),
        **{name: (pack(model.transition), "sigmoid")
           for name, (_, pack) in INT8_ENTRIES.items()},
    }
    bf16 = torch.bfloat16
    rng = np.random.default_rng(SEED)
    checks, checks_h48, int8_checks, d_errs = [], [], {k: [] for k in int8_packings}, []
    for b in CHECK_BATCHES:
        z, a = binary_latents(rng, b), onehot_actions(rng, b, num_actions)
        checks.append(check_transition(pt, z, a, latent))
        d_errs.append(check_decoder(pd, z))
        checks_h48.append(check_transition(pts, z, a, latent, " (h48 student)"))
        for name, (packed, head) in int8_packings.items():
            int8_checks[name].append(check_int8(name, packed, z.to(torch.int8), a, head))
    b, hw = RAGGED
    z, a = binary_latents(rng, b, hw), onehot_actions(rng, b, num_actions)
    checks.append(check_transition(pt, z, a, latent, f" ({hw}x{hw})"))
    checks_h48.append(check_transition(pts, z, a, latent, f" (h48 student, {hw}x{hw})"))
    d_errs.append(check_decoder(pd, z, f" ({hw}x{hw})"))
    for name, (packed, head) in int8_packings.items():
        int8_checks[name].append(check_int8(name, packed, z.to(torch.int8), a, head))
    for path in EXTRA_TRANSITIONS:
        params = load_pytree(f"{path}/model-transition.npz", "cuda")
        acts = params["conv1"]["w"].shape[2] - latent
        px = pack_transition_weights(params, latent, acts)
        label = f" ({path.split('/')[-1]}, hidden {px['w2'].shape[-1]}, {acts} actions"
        for b, hw in ((EXTRA_BATCH, 64), RAGGED):
            z, a = binary_latents(rng, b, hw), onehot_actions(rng, b, acts)
            checks.append(check_transition(px, z, a, latent, f"{label}, {hw}x{hw})"))
    for path in EXTRA_INT8:
        params = load_pytree(f"{path}/model-transition.npz", "cuda")
        for order, pack in INT8_PACKINGS.items():
            packed = pack(params)
            for b, hw in ((EXTRA_BATCH, 64), RAGGED):
                z, a = binary_latents(rng, b, hw), onehot_actions(rng, b, num_actions)
                check_int8(f"{path.split('/')[-1]} static", packed, z.to(torch.int8), a,
                           "sigmoid")
    dx = pack_decoder_weights(load_pytree(f"{EXTRA_DECODER}/model-decoder.npz", "cuda"),
                              latent)
    for b, hw in ((EXTRA_BATCH, 64), RAGGED):
        d_errs.append(check_decoder(dx, binary_latents(rng, b, hw),
                                    f" ({EXTRA_DECODER.split('/')[-1]}, {dx['color']} "
                                    f"colour, {hw}x{hw})"))
    t_err = max(c["t_err"] for c in checks + checks_h48)
    t_mismatch = (sum(c["n_flips"] for c in checks + checks_h48)
                  / sum(c["n_bits"] for c in checks + checks_h48))
    d_err = max(d_errs)
    int8_mismatch = {k: sum(n for n, _ in v) / sum(m for _, m in v)
                     for k, v in int8_checks.items()}
    int8_err = {k: float(any(n for n, _ in v)) for k, v in int8_checks.items()}

    # 4. the first main path: the teacher's free-run
    zero_counters()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = measure_prediction_mse(
        model, ds, batch_size=BATCH, timesteps=TIMESTEPS, make_plots=False,
        out_dir=out_dir,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counters()
    if result is None:
        raise AssertionError("degenerate trajectory batch")
    mse, mse_std, rew, rew_std = result
    frames = BATCH * (TIMESTEPS - 2)
    say(f"[main] measure_prediction_mse B={BATCH} T={TIMESTEPS}: "
        f"{wall:.3f} s wall (rollout included), {frames / wall:.1f} frames/s; "
        f"launches {launches}")
    say(f"[main] curve length {len(mse)}; pixel MSE first {mse[0]:.6g} "
        f"last {mse[-1]:.6g}; reward MSE first {rew[0]:.6g} last {rew[-1]:.6g}")
    if launches != {"fused_transition": TIMESTEPS - 1,
                    "fused_decode": TIMESTEPS - 2, "int8_transition": 0}:
        raise AssertionError(f"the main path did not run the kernels: {launches}")
    if not np.isfinite(np.array([mse, mse_std, rew, rew_std])).all():
        raise AssertionError("non-finite MSE curves")
    if len(mse) < COMPARE_STEPS:
        raise AssertionError("curve shorter than the comparison window")

    with torch.inference_mode():
        batch = ds.collect(BATCH, TIMESTEPS,
                           generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k_stats = _free_run_stats(model, batch, num_actions)
        torch.cuda.synchronize()
        free_wall = time.perf_counter() - t0
        short = tuple(x[:, :COMPARE_STEPS + 2] for x in batch)
        plain_stats = _free_run_stats(
            model, short, num_actions,
            transition_fn=lambda z, a: transition_plain(pt, z, a, dtype=bf16),
            decode_fn=lambda z: decode_plain(pd, z, dtype=bf16))
    k_curve = k_stats[0][:COMPARE_STEPS].cpu().numpy()
    p_curve = plain_stats[0].cpu().numpy()
    main_curve = np.asarray(mse[:COMPARE_STEPS])
    say(f"[main] free-run alone (batch collected beforehand): {free_wall:.3f} s, "
        f"{frames / free_wall:.1f} frames/s")
    say(f"[main] pixel MSE, first {COMPARE_STEPS} steps: main path "
        f"{np.array2string(main_curve, precision=6)}")
    say(f"[main]                                plain path "
        f"{np.array2string(p_curve, precision=6)}")
    if not np.allclose(k_curve, main_curve, rtol=1e-5, atol=1e-7):
        raise AssertionError("re-collected batch does not reproduce the main path")
    if not np.allclose(main_curve, p_curve, rtol=CURVE_RTOL, atol=CURVE_ATOL):
        raise AssertionError("main-path curve disagrees with the plain path")
    profile_free_run(model, batch, num_actions, frames)

    # 5. the second main path: the student fidelity gate
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fid = measure_fidelity(model, student, ds, tempfile.mkdtemp(prefix="chip_smoke_fid_"),
                           eval_batch_size=BATCH, eval_timesteps=FIDELITY_TIMESTEPS,
                           seed=SEED)
    torch.cuda.synchronize()
    fid_wall = time.perf_counter() - t0
    fid_launches = counters()
    steps = FIDELITY_TIMESTEPS
    say(f"[fidelity] measure_fidelity B={BATCH} T={steps}: {fid_wall:.3f} s wall "
        f"(three free-runs, their rollouts and the calibration); launches "
        f"{fid_launches}")
    with open(f"{STUDENT}/fidelity.json") as f:
        recorded = json.load(f)
    for key in ("teacher_mse", "student_mse", "delta_pct", "student_int8_mse",
                "int8_delta_pct"):
        say(f"[fidelity] {key:17s} port {json.dumps(fid[key])}")
        say(f"[fidelity] {'':17s} JAX  {json.dumps(recorded[key])}")
    say(f"[fidelity] mse10_delta_pct port {fid['mse10_delta_pct']:.4f}, JAX "
        f"{recorded['mse10_delta_pct']:.4f} (JAX per seed "
        f"{recorded['mse10_delta_per_seed']}); within_1pct port "
        f"{fid['within_1pct']}, JAX {recorded['within_1pct']}")
    if fid_launches != {"fused_transition": 2 * (steps - 1),
                        "fused_decode": 3 * (steps - 2),
                        "int8_transition": steps - 1}:
        raise AssertionError(f"the fidelity path did not run the kernels: {fid_launches}")
    if not np.isfinite([v for k in ("teacher_mse", "student_mse", "student_int8_mse")
                        for v in fid[k].values()]).all():
        raise AssertionError("non-finite fidelity record")

    student_model = model._replace(transition=student)
    with torch.inference_mode():
        batch = ds.collect(BATCH, steps, generator=torch.Generator(
            device="cuda").manual_seed(SEED + 12345))
        q_kernel = _free_run_stats(
            student_model, batch, num_actions,
            transition_fn=lambda z, a: transition_int8_v2(qt, z, a))[0].cpu().numpy()
        q_plain = _free_run_stats(
            student_model, batch, num_actions,
            transition_fn=lambda z, a: i8.int8_transition_plain(
                qt.packed, (z > 0.5).to(torch.int8), a).float())[0].cpu().numpy()
    horizons = sorted(fid["student_int8_mse"])
    say(f"[fidelity] int8 pixel MSE, kernel {np.array2string(q_kernel[:10], precision=6)}")
    say(f"[fidelity]                 plain  {np.array2string(q_plain[:10], precision=6)}")
    if not np.allclose(q_kernel, q_plain, rtol=INT8_CURVE_RTOL, atol=0):
        raise AssertionError("int8 free-run curve disagrees with the plain int8 version")
    if not np.allclose([fid["student_int8_mse"][h] for h in horizons],
                       q_kernel[horizons], rtol=INT8_CURVE_RTOL, atol=0):
        raise AssertionError("re-collected batch does not reproduce the int8 run")
    gate_f32 = gate_in_f32(model, student, qt, batch, num_actions, latent)
    say(f"[fidelity] MSE@t+10 through the plain f32 transition and decoder, same "
        f"batch: teacher {gate_f32['teacher']:.6g} (record, bf16 kernels: "
        f"{fid['teacher_mse'][10]:.6g}); exact student {gate_f32['student']:.6g} "
        f"({fid['student_mse'][10]:.6g}); int8 student with the f32 decoder "
        f"{gate_f32['int8']:.6g} ({fid['student_int8_mse'][10]:.6g}); int8 delta "
        f"{gate_f32['int8_delta_pct']:.4f}% (record {fid['int8_delta_pct'][10]:.4f}%), "
        f"exact student delta {gate_f32['delta_pct']:.4f}% (record "
        f"{fid['delta_pct'][10]:.4f}%)")

    # 6. the third main path: training at full width, its evaluation hook
    # through the kernels, and the checks of the training arithmetic
    train_launches, train_ms = train_phase(ds, latent)

    # 7. times at the main paths' shapes (B = 100): inputs as the free-run
    # hands them over (f32 latents, f32 one-hot actions).
    rng = np.random.default_rng(SEED + 1)
    z = binary_latents(rng, BATCH)
    a = onehot_actions(rng, BATCH, num_actions)
    zi = z.to(torch.int8)
    color = pd["color"]
    b, h, w = BATCH, 64, 64
    times = {}
    with torch.inference_mode():
        for key, packed_t in (("fused_transition", pt), ("fused_transition_h48", pts)):
            times[key] = {
                "ms": cuda_ms(lambda: fused_transition(packed_t, z, a)),
                "plain_ms": cuda_ms(lambda: transition_plain(packed_t, z, a, dtype=bf16),
                                    iters=5),
                "library_ms": cuda_ms(lambda: library_transition(packed_t, z, a)),
                "bound": bound(*transition_cost(packed_t, z, a))}
        times["fused_decode"] = {
            "ms": cuda_ms(lambda: fused_decode(pd, z)),
            "plain_ms": cuda_ms(lambda: decode_plain(pd, z, dtype=bf16), iters=5),
            "library_ms": cuda_ms(lambda: library_decode(pd, z))}
        for name, (packed, head) in int8_packings.items():
            times[name] = {
                "ms": cuda_ms(lambda: i8.int8_transition(packed, zi, a, head=head)),
                "plain_ms": cuda_ms(lambda: i8.int8_transition_plain(
                    packed, zi, a, head=head), iters=3),
                "library_ms": None,
                "bound": bound(*int8_cost(packed, zi, a), peak=PEAK_INT8_OPS)}
        # the int8 kernel in every epilogue order (static packings), beside
        # the bf16 kernel at the same width, in this run
        int8_orders = {}
        for width, params, bf16_key in ((128, model.transition, "fused_transition"),
                                        (48, student, "fused_transition_h48")):
            row = {order: cuda_ms(lambda packed=pack(params):
                                  i8.int8_transition(packed, zi, a, head="sigmoid"))
                   for order, pack in INT8_PACKINGS.items()}
            row["bf16_ms"] = times[bf16_key]["ms"]
            int8_orders[width] = row
        int8_orders[48]["calibrated_joint"] = times["transition_int8_v2"]["ms"]
        # both kernels at the shapes no shipped model has (random weights;
        # 50 and 104 run at 64 and 112 on zero-padded operands, 144 and
        # 256 as two output-channel tiles, latents 8 and 32 as conv1's K
        # and the head's N zero-padded to 16 and 32)
        width_times = {}
        for lat, hidden in SHAPE_TIME_CASES:
            params = random_transition(hidden, num_actions, SEED + hidden, lat)
            pw = pack_transition_weights(params, lat, num_actions)
            qw = quantize_transition(params).packed
            zw = z if lat == latent else binary_latents(rng, BATCH, latent=lat)
            zwi = zw.to(torch.int8)
            width_times[shape_key(lat, hidden)] = {
                "latent": lat, "hidden": hidden,
                "ms": cuda_ms(lambda: fused_transition(pw, zw, a)),
                "plain_ms": cuda_ms(lambda: transition_plain(pw, zw, a, dtype=bf16), iters=5),
                "library_ms": cuda_ms(lambda: library_transition(pw, zw, a)),
                "bound": bound(*transition_cost(pw, zw, a)),
                "int8_ms": cuda_ms(lambda: i8.int8_transition(qw, zwi, a, head="sigmoid")),
                "int8_plain_ms": cuda_ms(lambda: i8.int8_transition_plain(
                    qw, zwi, a, head="sigmoid"), iters=3),
                "int8_bound": bound(*int8_cost(qw, zwi, a), peak=PEAK_INT8_OPS)}
        # the decoder at the other latents (random weights, intermediate 4L)
        decode_times = {}
        for lat in DECODE_TIME_LATENTS:
            pl_ = pack_decoder_weights(init_decoder(
                torch.Generator(device="cuda").manual_seed(SEED + lat), lat, color), lat)
            zl = binary_latents(rng, BATCH, latent=lat)
            decode_times[lat] = {
                "ms": cuda_ms(lambda: fused_decode(pl_, zl)),
                "plain_ms": cuda_ms(lambda: decode_plain(pl_, zl, dtype=bf16), iters=5),
                "library_ms": cuda_ms(lambda: library_decode(pl_, zl)),
                "bound": bound(*decode_cost(pl_, zl))}
    times["fused_decode"]["bound"] = bound(*decode_cost(pd, z))
    for name, t in times.items():
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
        say(f"[time] {name}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {lib}, bound {t['bound'][0]:.4f} ms ({t['bound'][1]}; "
            f"{100 * t['bound'][0] / t['ms']:.1f}% of bound)")
    for width, row in int8_orders.items():
        say(f"[time] int8 kernel at hidden {width}, ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items() if k != "bf16_ms")
            + f"; bf16 kernel at hidden {width}: {row['bf16_ms']:.4f}")
    for r in width_times.values():
        hp = kernel_hidden(r["hidden"])
        say(f"[time] latent {r['latent']}, hidden {r['hidden']} (kernel width {hp}, N tiles "
            f"{[n for _, n in n_tiles(hp)]}, random weights): "
            f"bf16 kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, cuDNN "
            f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} ({r['bound'][1]}; "
            f"{100 * r['bound'][0] / r['ms']:.1f}% of bound); int8 kernel (static joint) "
            f"{r['int8_ms']:.4f} ms, plain {r['int8_plain_ms']:.4f}, bound "
            f"{r['int8_bound'][0]:.4f} ({r['int8_bound'][1]})")
    for lat, r in decode_times.items():
        say(f"[time] decoder at latent {lat} (intermediate {4 * lat}, {color} colours, random "
            f"weights): kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, cuDNN "
            f"{r['library_ms']:.4f}, bound {r['bound'][0]:.4f} ({r['bound'][1]}; "
            f"{100 * r['bound'][0] / r['ms']:.1f}% of bound)")

    # 8. the fourth main path: MPC planning and play (gridworld_cf, pong_cf_60k)
    mpc = mpc_phase()
    t_err = max([t_err] + [c["t_err"] for c in mpc["checks"]])

    # 9. the fifth main path: the command line
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    cli_runs = cli_phase()
    t_err = max([t_err] + [c["t_err"] for c in cli_runs["checks"]])
    d_err = max([d_err] + cli_runs["d_errs"])

    # 10. the sixth main path: the env zoo and its shipped bundles
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    zoo = zoo_phase()
    t_err = max([t_err] + [c["t_err"] for c in zoo["checks"]])
    d_err = max([d_err] + zoo["d_errs"])

    # 11. the seventh main path: make a student
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    made = distill_phase(model, student, qt, ds)

    # 12. the eighth main path: a host actor's replay buffer feeds training
    # and the free-run
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    replay = replay_phase(model, latent, (mse, rew), train_ms, cli_runs["videos"])

    # 13. the ninth main path: the device mesh (one card: a one-process
    # NCCL group), the pipeline and the spatial transition
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    mesh = mesh_phase(model, ds)

    # 14. every model shape: the kernels at the shapes no shipped model has,
    # a student made at h96, centipede, a latent-8 and a latent-32 /
    # hidden-256 model
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    shapes = shapes_phase(model, ds)
    t_err = max([t_err] + [c["t_err"] for c in shapes["checks"]])
    d_err = max([d_err] + shapes["d_errs"])

    # 15. the kernels line.  launches: the sum over the main paths, each
    # counted from 0 (launches_by_path splits it).
    def row(name, key, source, replaces, err, **extra):
        t = times[key]
        counter = extra.pop("counter")
        by_path = {"measure_prediction_mse": launches[counter],
                   "measure_fidelity": fid_launches[extra.pop("fid_counter")],
                   "train": train_launches[counter],
                   **{path: n[counter] for path, n in mpc["launches"].items()},
                   "cli": cli_runs["launches"][counter],
                   "zoo": zoo["launches"][counter],
                   "distill": made["launches"][counter],
                   "host_replay": replay["launches"][counter],
                   "mesh": mesh["launches"][counter],
                   "shapes": shapes["launches"][counter]}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"], **extra}

    h48 = times["fused_transition_h48"]
    widths = {h: {"ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                  "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
              for h, r in width_times.items()}
    latents_d = {lat: {"ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                       "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                 for lat, r in decode_times.items()}
    widths_int8 = {h: {"ms": r["int8_ms"], "plain_ms": r["int8_plain_ms"],
                       "bound_ms": r["int8_bound"][0], "bound_by": r["int8_bound"][1]}
                   for h, r in width_times.items()}
    v2 = times["transition_int8_v2"]
    serving = {"packing": "transition_int8_v2, calibrated h48 student",
               "ms": v2["ms"], "plain_ms": v2["plain_ms"], "bound_ms": v2["bound"][0],
               "mismatch_fraction": int8_mismatch["transition_int8_v2"],
               "orders_ms": int8_orders[48]}
    kernels = [
        row("fused_transition", "fused_transition",
            "scmgan_tpu_torch/csrc/fused_transition.cu",
            "scmgan_tpu/ops/pallas/fused_transition.py:214", t_err,
            counter="fused_transition", fid_counter="fused_transition",
            mismatch_fraction=t_mismatch,
            h48={"ms": h48["ms"], "plain_ms": h48["plain_ms"],
                 "bound_ms": h48["bound"][0], "library_ms": h48["library_ms"]},
            widths=widths,
            mpc_shapes={k: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                            "library_ms": r["library_ms"], "bound_ms": r["bound"][0]}
                        for k, r in mpc["times"].items()}),
        row("fused_decode", "fused_decode", "scmgan_tpu_torch/csrc/fused_decoder.cu",
            "scmgan_tpu/ops/pallas/fused_decoder.py:126", d_err,
            counter="fused_decode", fid_counter="fused_decode", latents=latents_d),
        *(row(name, name, "scmgan_tpu_torch/csrc/int8_transition.cu", replaces,
              int8_err[name],
              counter="int8_transition", fid_counter="int8_transition",
              mismatch_fraction=int8_mismatch[name],
              library_note="no PyTorch call computes an int8 convolution",
              orders_ms=int8_orders[128], serving_h48=serving,
              widths_static_joint=widths_int8,
              mpc_shapes_calibrated={k: {"ms": r["int8_ms"], "plain_ms": r["int8_plain_ms"],
                                         "bound_ms": r["int8_bound"][0]}
                                     for k, r in mpc["times"].items()})
          for name, (replaces, _) in INT8_ENTRIES.items()),
    ]
    say(f"[done] build {build_s:.2f} s, total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    faulthandler.cancel_dump_traceback_later()
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
