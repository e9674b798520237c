"""Single experiment configuration.

Port of ``scmgan_tpu/config.py``: the same fields with the same defaults, so
one set of settings describes a run on either package.  ``pdtype`` and
``cdtype`` are ``torch.dtype``s.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Config:
    # --- experiment -------------------------------------------------------
    env: str = "pong"
    load_from: Optional[str] = None
    evaluate: bool = False
    evaluations: int = 1
    title: Optional[str] = None
    seed: int = 0
    out_dir: str = "."

    # --- model ------------------------------------------------------------
    latent_dim: int = 16          # hardcoded 16 in the reference (main.py:65)
    hidden_dim: int = 128         # conv width (models.py:51-56,129-134)
    encoder_frames: int = 3       # ENCODER_INPUT_FRAMES (models.py:19)
    noise_dim: int = 3            # NOISE_DIM (models.py:18)

    # --- training ---------------------------------------------------------
    batch_size: int = 32
    train_iters: int = 10_000
    start_iter: int = 1
    learning_rate: float = 1e-4
    truncate_bptt: bool = False
    latent_overshooting: bool = False
    latent_td: bool = False
    td_lambda: float = 0.9
    td_steps: int = 3
    horizon_min: int = 3
    horizon_max: int = 10
    finetune_reward: bool = False
    reward_coef: float = 1e-3
    # Parsed at 1e-2 by the reference, whose L1 terms are commented out
    # (main.py:199-213): 0.0 is its real behaviour; nonzero enables them.
    activation_l1_coef: float = 0.0
    transition_l1_coef: float = 0.0
    # Ablation: keep the sigmoid latents at train time, no Bernoulli draw
    # (reference scripts/generate_mse_plot_deterministic.py:41-67).
    deterministic_transition: bool = False
    remat_transition: bool = False  # recompute the BPTT transition's
                                    # activations in backward
    scan_unroll: int = 1            # the JAX package's lax.scan unroll; no
                                    # effect here: the port's time loop is an
                                    # eager Python loop
    enable_action_control_loss: bool = False
    enable_disentanglement_loss: bool = False
    counterfactual_horizon: int = 1
    grad_clip_value: float = 0.1       # clip_grad_value_(…, 0.1) (main.py:288-290)

    # constants mirrored from the reference (main.py:53-55)
    iters_per_video: int = 2000
    cf_regularization_rate: int = 5
    cf_regularization_lambda: float = 1e-2

    # --- numerics / hardware ----------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"    # losses accumulate in f32
    data_axis: str = "data"
    model_axis: str = "model"
    # (data, model) device mesh shape; None: one device
    mesh_shape: Optional[tuple] = None

    # --- evaluation --------------------------------------------------------
    eval_batch_size: int = 100         # measure_prediction_mse (main.py:787)
    eval_timesteps: int = 100
    mpc_rollout_depth: int = 12        # compute_rollout_reward (main.py:456)
    mpc_lookahead: int = 2
    mpc_negative_tradeoff: float = 10.0
    mpc_max_steps: int = 300           # episode time limit (main.py:393-395)
    mpc_samples: int = 1
    mpc_policy: str = "noop"
    mpc_stall_patience: int = 10

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
