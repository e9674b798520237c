"""Training engine: per-network optimizers, the train step, and the outer
loop with the horizon curriculum, periodic evaluation and checkpointing.

Port of ``scmgan_tpu/train/trainer.py``, reproducing the reference
(main.py:106-298):
  * one Adam per network at the same learning rate (main.py:125-129)
  * element-wise gradient value clipping at 0.1 on encoder, transition and
    decoder only (main.py:287-290), before Adam
  * the reward predictor always steps; the other three networks are frozen
    under ``finetune_reward`` (main.py:292-296)
  * a linear horizon curriculum from horizon_min to horizon_max
    (main.py:143-145)
  * evaluation and checkpoint hooks every ``iters_per_video`` iterations
    (main.py:133-141)

The spectral-norm power iteration refreshes u/v once per step, after Adam
(``ops/spectral_norm.update_spectral_norms``).  Every parameter of a stepped
network takes every step, with a zero gradient where the loss does not
reach it, as optax steps it: one count per network, as ``opt_state.npz``
records it.  Optax and ``torch.optim.Adam``
place epsilon and the bias corrections alike (lr * m_hat / (sqrt(v_hat) +
eps)); they round the moments' updates in another order.

Under a device mesh (``mesh_and_rules``, a ``DeviceMesh`` from
``parallel.mesh.make_mesh``) the state's parameters and Adam moments are
stored sharded over 'model', each process steps its rows of the batch
('data'), and the step gathers the parameters, averages the gradients over
'data' before the clip and refreshes the spectral norms on the gathered
weights (``parallel/mesh.py``): the same step, within float tolerance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from scmgan_tpu_torch.config import Config
from scmgan_tpu_torch.models.world_model import WorldModel, init_world_model
from scmgan_tpu_torch.ops.spectral_norm import update_spectral_norms
from scmgan_tpu_torch.train.losses import LossConfig, LossNoise, world_model_loss

# Networks whose gradients are value-clipped before Adam, and which
# finetune_reward freezes (trainer.py:58-64).
CLIPPED = ("encoder", "decoder", "transition")


@dataclasses.dataclass
class TrainState:
    """Parameters, one Adam per trained network (a frozen network has
    none), and the step count.  Adam updates the parameters in place.
    Under a mesh, ``params`` and the moments hold this process's shards and
    ``shardings`` says how each leaf lies (``parallel.mesh``); else None."""

    params: WorldModel
    optimizers: Dict[str, torch.optim.Adam]
    step: int
    shardings: Optional[Any] = None


def trainable_leaves(network: dict):
    """The tensors an optimizer steps: every leaf but the spectral-norm
    u/v state, in a fixed order."""
    out = []
    for key in sorted(network):
        node = network[key]
        if key == "sn":
            continue
        if isinstance(node, dict):
            out.extend(trainable_leaves(node))
        else:
            out.append(node)
    return out


def make_optimizer(cfg: Config, params: WorldModel) -> Dict[str, torch.optim.Adam]:
    """One Adam per network at ``cfg.learning_rate`` (trainer.py:50); under
    ``finetune_reward`` the clipped networks get none and stop requiring
    gradients.  Marks the stepped leaves as requiring gradients."""
    optimizers = {}
    for name in WorldModel._fields:
        frozen = cfg.finetune_reward and name in CLIPPED
        leaves = trainable_leaves(getattr(params, name))
        for leaf in leaves:
            leaf.requires_grad_(not frozen)
        if not frozen:
            optimizers[name] = torch.optim.Adam(leaves, lr=cfg.learning_rate)
    return optimizers


def init_train_state(cfg: Config, spec, generator: torch.Generator) -> TrainState:
    """Fresh parameters drawn from ``generator`` on its device, and their
    optimizers (trainer.py:74)."""
    params = init_world_model(
        generator, cfg.latent_dim, spec.num_actions, spec.num_rewards,
        spec.channels, spec.channels, hidden=cfg.hidden_dim,
        img_size=(spec.height, spec.width), dtype=cfg.pdtype)
    return TrainState(params, make_optimizer(cfg, params), cfg.start_iter)


def horizon_at(cfg: Config, train_iter: int) -> int:
    """Linear curriculum (reference main.py:143-145)."""
    theta = train_iter / cfg.train_iters
    delta = cfg.horizon_max - cfg.horizon_min
    return cfg.horizon_min + int(delta * theta)


def loss_config(cfg: Config, horizon: int) -> LossConfig:
    return LossConfig(
        horizon=horizon,
        truncate_bptt=cfg.truncate_bptt,
        latent_overshooting=cfg.latent_overshooting,
        latent_td=cfg.latent_td,
        td_steps=cfg.td_steps,
        enable_cf_shuffle=cfg.enable_disentanglement_loss,
        enable_cf_control=cfg.enable_action_control_loss,
        counterfactual_horizon=cfg.counterfactual_horizon,
        reward_coef=cfg.reward_coef,
        td_lambda=cfg.td_lambda,
        cf_lambda=cfg.cf_regularization_lambda,
        activation_l1_coef=cfg.activation_l1_coef,
        transition_l1_coef=cfg.transition_l1_coef,
        deterministic_transition=cfg.deterministic_transition,
        remat_transition=cfg.remat_transition,
        scan_unroll=cfg.scan_unroll,
    )


def make_train_step(cfg: Config, horizon: int, mesh_and_rules=None):
    """The train step for one horizon bucket:
    fn(state, batch, noise, theta, cf_active) -> (state, metrics).

    Loss, backward, the value clip on the clipped networks, one Adam step
    per network, then the spectral-norm refresh (trainer.py:123).  The
    returned metrics are detached f32 scalars on the device.  With
    ``mesh_and_rules`` (a ``DeviceMesh``) the step is
    ``parallel.mesh.shard_train_step``'s: ``batch`` holds this process's
    rows and ``noise`` draws the global batch's numbers.
    """
    lcfg = loss_config(cfg, horizon)

    def step_fn(state: TrainState, batch, noise: LossNoise, theta, cf_active,
                sharded=None):
        obs, rewards, dones, actions = batch
        for opt in state.optimizers.values():
            opt.zero_grad(set_to_none=True)
        params = state.params if sharded is None else sharded.gather(state.params)
        loss, metrics = world_model_loss(
            params, (obs.to(cfg.cdtype), rewards, dones, actions),
            noise, theta, cf_active, lcfg)
        loss.backward()
        with torch.no_grad():
            if sharded is not None:
                sharded.shard_grads()
            for opt in state.optimizers.values():
                for group in opt.param_groups:
                    for p in group["params"]:
                        if p.grad is None:
                            # a leaf the loss does not reach (the transition at
                            # horizon 3, the discriminator): optax steps it with
                            # a zero gradient, counting the step and decaying
                            # its moments
                            p.grad = torch.zeros_like(p)
            if sharded is not None:
                # the global gradient, before the clip sees it
                sharded.reduce_grads([p for opt in state.optimizers.values()
                                      for group in opt.param_groups
                                      for p in group["params"]])
            for name, opt in state.optimizers.items():
                if name in CLIPPED:
                    for group in opt.param_groups:
                        for p in group["params"]:
                            p.grad.clamp_(-cfg.grad_clip_value, cfg.grad_clip_value)
                opt.step()
            if sharded is None:
                params = update_spectral_norms(state.params)
            else:
                params = sharded.refresh_spectral_norms(state.params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if sharded is not None:
            metrics = sharded.mean_metrics(metrics)
        return (TrainState(params, state.optimizers, state.step + 1, state.shardings),
                metrics)

    if mesh_and_rules is not None:
        from scmgan_tpu_torch.parallel.mesh import shard_train_step

        return shard_train_step(step_fn, mesh_and_rules, cfg.data_axis, cfg.model_axis)
    return step_fn


def train(cfg: Config, datasource, state: Optional[TrainState] = None, *,
          mesh_and_rules=None, eval_fn=None, checkpoint_fn=None, log_fn=None,
          generator: Optional[torch.Generator] = None) -> TrainState:
    """The outer training loop (reference train(), main.py:106-298).

    ``eval_fn(state, train_iter)``, ``checkpoint_fn(state, train_iter)`` and
    ``log_fn(train_iter, metrics)`` are host-side hooks, called in the JAX
    loop's order: evaluation and checkpoint before the step of every
    ``iters_per_video``-th iteration.  ``generator`` (on the datasource's
    device; default seeded with ``cfg.seed``) draws the initial parameters
    when ``state`` is None, every batch and every loss draw.

    Under ``mesh_and_rules`` the state is laid out on the mesh and each
    process steps the rows ``process_batch_slice`` gives it: a device
    (synthetic) datasource collects the global batch from ``generator``,
    which every process seeds alike, and keeps those rows, so that a
    'data'-split run trains as the one-device run does.  A host
    datasource, whose actors live in each process, collects its rows alone
    (trainer.py:186): the first process of each 'model' group collects
    them and sends them, with its generator's state, to the others of the
    group (``share_model_batch``), whose actors never start.  Its
    ``collect`` takes one draw of ``generator`` whatever it returns, so the
    'data' groups' generators stay in step.  The hooks get the sharded
    state.

    Each horizon's step is built once.
    """
    if generator is None:
        generator = torch.Generator(device=datasource.device).manual_seed(cfg.seed)
    if state is None:
        state = init_train_state(cfg, datasource.spec, generator)

    rows, host, steps = None, False, {}
    if mesh_and_rules is not None:
        from scmgan_tpu_torch.data.datasource import Datasource
        from scmgan_tpu_torch.parallel.distributed import process_batch_slice
        from scmgan_tpu_torch.parallel.mesh import shard_train_state, share_model_batch

        if state.shardings is None:
            state = shard_train_state(state, mesh_and_rules, cfg.model_axis)
        local_batch, batch_offset = process_batch_slice(
            cfg.batch_size, mesh_and_rules, cfg.data_axis)
        rows = slice(batch_offset, batch_offset + local_batch)
        host = not isinstance(datasource, Datasource)
        collects = mesh_and_rules.get_local_rank(cfg.model_axis) == 0

    nan_check_every = 200  # training-health watchdog (trainer.py:197)
    for train_iter in range(cfg.start_iter, cfg.train_iters + 1):
        if train_iter % cfg.iters_per_video == 0:
            if eval_fn is not None:
                eval_fn(state, train_iter)
            if checkpoint_fn is not None:
                checkpoint_fn(state, train_iter)

        horizon = horizon_at(cfg, train_iter)
        theta = train_iter / cfg.train_iters
        cf_active = 1.0 if train_iter % cfg.cf_regularization_rate == 0 else 0.0

        if host:
            batch = datasource.collect(rows.stop - rows.start, horizon,
                                       generator=generator) if collects else None
            batch = share_model_batch(batch, generator, mesh_and_rules, cfg.model_axis)
        else:
            batch = datasource.collect(cfg.batch_size, horizon, generator=generator)
            if rows is not None:
                batch = tuple(x[rows] for x in batch)
        if horizon not in steps:
            steps[horizon] = make_train_step(cfg, horizon, mesh_and_rules)
        state, metrics = steps[horizon](state, batch, LossNoise(generator), theta,
                                        cf_active)
        if train_iter % nan_check_every == 0:
            loss_val = float(metrics["loss"])
            if loss_val != loss_val:  # NaN
                raise FloatingPointError(
                    f"training loss became NaN at iter {train_iter} "
                    f"(horizon {horizon}); check learning rate / inputs")
        if log_fn is not None:
            log_fn(train_iter, metrics)
    return state
