"""Command-line entry point: ``python -m scmgan_tpu_torch --env pong ...``.

Port of ``scmgan_tpu/cli/main.py`` with the reference's exact flag surface
(reference main.py:25-51) and the JAX package's extras, option for option:
training with periodic evaluation and exact-resume checkpoints,
``--evaluate`` (N MPC playthroughs, then the training-set evaluation and,
on request, the causal graph and the Higgins metric; main.py:92-99),
``--load-from`` (``model-*.npz`` with ``opt_state.npz`` / ``step.npz``, or
the reference's ``model-*.pth``) and ``--student``.

``--platform`` picks the device: ``cuda`` by default, ``cpu`` on request;
there is no fall-back to the CPU when no card is found.  ``--mesh DxM``
trains on a device mesh of D x M processes, one per device, launched as
``torchrun --nproc-per-node 2 -m scmgan_tpu_torch --platform cpu --mesh 2x1
...`` (NCCL between cards, gloo on the CPU; ``--mesh 1x1`` needs no
launcher): the parameters are sharded over M, the batch over D
(``parallel/``); the evaluation hook runs on the first process, on the
gathered parameters, and the checkpoint is written whole by it.  As in the
JAX package, ``--evaluate`` ignores the mesh.  ``--no-videos`` also
turns off the playthroughs' videos.  The TensorBoard mirror (where
tensorboardX imports) writes under ``<out-dir>/runs``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Learn to model a sequential environment (PyTorch/CUDA port)")
    p.add_argument("--env", required=True,
                   help="A synthetic env (minipacman, gridworld, pong/betterpong, "
                        "...; see scmgan_tpu_torch/envs for the registry) or a "
                        "host datasource: gym:<Name> (any pixel gym/gymnasium "
                        "env), sc2_* (StarCraft II), atari, centipede")
    p.add_argument("--load-from", type=str, default=None,
                   help="Directory containing model-*.npz checkpoints")
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--evaluations", type=int, default=1)
    p.add_argument("--title", type=str, default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--train-iters", type=int, default=10000)
    p.add_argument("--start-iter", type=int, default=1)
    p.add_argument("--truncate-bptt", action="store_true")
    p.add_argument("--latent-overshooting", action="store_true")
    p.add_argument("--latent-td", action="store_true")
    p.add_argument("--td-lambda", type=float, default=0.9)
    p.add_argument("--td-steps", type=int, default=3)
    p.add_argument("--horizon-min", type=int, default=3)
    p.add_argument("--horizon-max", type=int, default=10)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--finetune-reward", action="store_true")
    p.add_argument("--reward-coef", type=float, default=1e-3)
    # The reference parses these at 1e-2 but never applies them (its L1 loss
    # block is commented out, main.py:199-213), so its behavioural default
    # is off: 0.0 here, and a nonzero value is applied.
    p.add_argument("--activation-l1-coef", type=float, default=0.0)
    p.add_argument("--transition-l1-coef", type=float, default=0.0)
    p.add_argument("--deterministic-transition", action="store_true",
                   help="Disable the straight-through Bernoulli sampler at "
                        "train time (deterministic-model ablation axis)")
    p.add_argument("--enable-action-control-loss", action="store_true")
    p.add_argument("--enable-disentanglement-loss", action="store_true")
    p.add_argument("--counterfactual-horizon", type=int, default=1)
    # extras beyond the reference
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", type=str, default=".")
    p.add_argument("--compute-dtype", type=str, default="bfloat16")
    p.add_argument("--scan-unroll", type=int, default=1,
                   help="The JAX package's BPTT unroll factor; the port's "
                        "time loop is eager, so it has no effect here")
    p.add_argument("--mesh", type=str, default=None,
                   help="Device mesh as DATAxMODEL, e.g. 4x2: one process "
                        "per device (torchrun), DATA*MODEL = WORLD_SIZE")
    p.add_argument("--no-videos", action="store_true")
    p.add_argument("--platform", type=str, default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--eval-batch-size", type=int, default=100)
    p.add_argument("--eval-timesteps", type=int, default=100)
    p.add_argument("--iters-per-video", type=int, default=2000,
                   help="Evaluate + checkpoint every N iters "
                        "(ITERS_PER_VIDEO in the reference)")
    p.add_argument("--higgins", action="store_true",
                   help="With --evaluate: compute the Higgins "
                        "disentanglement metric (envs with a simulator)")
    p.add_argument("--causal-graph", action="store_true",
                   help="With --evaluate: extract + render the causal graph")
    p.add_argument("--causal-runs", type=int, default=10,
                   help="Batches to max over for the causal graph "
                        "(reference uses 10, main.py:514)")
    p.add_argument("--higgins-iters", type=int, default=500,
                   help="Classifier training iterations for the Higgins "
                        "metric (reference conv protocol default, "
                        "higgins.py:91)")
    p.add_argument("--mpc-int8", action="store_true",
                   help="Route the MPC planning beam through the int8 "
                        "transition kernel")
    p.add_argument("--mpc-samples", type=int, default=1,
                   help="Monte-Carlo rollouts per plan: roll the beam tail "
                        "K times with the model's own Bernoulli sampling "
                        "and score each plan by its MEAN return, instead "
                        "of one chaotic deterministic future (exact path "
                        "only)")
    p.add_argument("--mpc-lookahead", type=int, default=2,
                   help="Enumerated action prefix length of the planning "
                        "beam (reference: 2, main.py:456)")
    p.add_argument("--mpc-depth", type=int, default=12,
                   help="Planning beam rollout depth (reference: 12)")
    p.add_argument("--mpc-policy", type=str, default="noop",
                   choices=["noop", "random", "greedy"],
                   help="Beam tail policy: reference noop/random "
                        "(main.py:467-471) or the 1-step-greedy tail "
                        "(argmax of predicted step reward)")
    p.add_argument("--mpc-tradeoff", type=float, default=10.0,
                   help="Planning-beam weight on reward channel 0 "
                        "(main.py:483-484).  NOTE: in pos/neg-split envs "
                        "(minipacman) channel 0 is the POSITIVE channel, so "
                        "the reference's 10.0 is greed, not caution; values "
                        "< 1 weight the negative channel up relatively "
                        "(e.g. 0.1 = death-averse)")
    p.add_argument("--mpc-stall-patience", type=int, default=10,
                   help="Take one random action after N bit-identical "
                        "real frames, which breaks the reward-hallucination "
                        "fixed point of the deterministic beam (0 = off)")
    p.add_argument("--student", type=str, default=None,
                   help="Directory of a distilled serving transition: swaps "
                        "it in for evaluate/play.  Refuses if its recorded "
                        "fidelity gate (within 1%% MSE@t+10) failed.")
    return p


def config_from_args(args):
    """The port's ``Config`` from parsed arguments (cli/main.py:119)."""
    from scmgan_tpu_torch.config import Config

    mesh_shape = None
    if args.mesh:
        d, m = args.mesh.lower().split("x")
        mesh_shape = (int(d), int(m))
    return Config(
        env=args.env,
        load_from=args.load_from,
        evaluate=args.evaluate,
        evaluations=args.evaluations,
        title=args.title,
        batch_size=args.batch_size,
        train_iters=args.train_iters,
        start_iter=args.start_iter,
        truncate_bptt=args.truncate_bptt,
        latent_overshooting=args.latent_overshooting,
        latent_td=args.latent_td,
        td_lambda=args.td_lambda,
        td_steps=args.td_steps,
        horizon_min=args.horizon_min,
        horizon_max=args.horizon_max,
        learning_rate=args.learning_rate,
        finetune_reward=args.finetune_reward,
        reward_coef=args.reward_coef,
        activation_l1_coef=args.activation_l1_coef,
        transition_l1_coef=args.transition_l1_coef,
        deterministic_transition=args.deterministic_transition,
        enable_action_control_loss=args.enable_action_control_loss,
        enable_disentanglement_loss=args.enable_disentanglement_loss,
        counterfactual_horizon=args.counterfactual_horizon,
        seed=args.seed,
        out_dir=args.out_dir,
        compute_dtype=args.compute_dtype,
        scan_unroll=args.scan_unroll,
        mesh_shape=mesh_shape,
        eval_batch_size=args.eval_batch_size,
        eval_timesteps=args.eval_timesteps,
        iters_per_video=args.iters_per_video,
        mpc_samples=args.mpc_samples,
        mpc_lookahead=args.mpc_lookahead,
        mpc_rollout_depth=args.mpc_depth,
        mpc_policy=args.mpc_policy,
        mpc_stall_patience=args.mpc_stall_patience,
        mpc_negative_tradeoff=args.mpc_tradeoff,
    )


def platform_device(platform) -> torch.device:
    """``--platform`` as a device: cuda by default, cpu on request; raises
    for any other name, and for cuda when no card is available."""
    from scmgan_tpu_torch.utils.device import resolve_device

    name = platform or "cuda"
    if name not in ("cuda", "cpu"):
        raise ValueError(f"--platform {platform!r}: the port runs on 'cuda' or 'cpu'")
    return resolve_device(name)


def main(argv=None) -> dict:
    """Run the command line on ``argv``.  Returns what it computed: the
    final ``state``; with ``--evaluate`` also the playthroughs' ``scores``
    (cumulative reward, steps), the ``evaluate`` curves, the
    ``causal_graph`` matrix and the ``higgins`` accuracies, where run."""
    args = build_parser().parse_args(argv)
    device = platform_device(args.platform)
    cfg = config_from_args(args)

    # The mesh comes first: under NCCL joining the group binds this
    # process's card, on which everything below is made.
    if cfg.mesh_shape is None:
        return _run(args, cfg, device, None, 0, cfg.seed)
    from scmgan_tpu_torch.parallel import distributed
    from scmgan_tpu_torch.parallel.mesh import make_mesh

    try:
        distributed.initialize(backend="nccl" if device.type == "cuda" else "gloo")
        mesh = make_mesh(cfg.mesh_shape, (cfg.data_axis, cfg.model_axis),
                         device_type=device.type)
        # JAX's per-process seed (cli/main.py:187-191), by 'data'
        # coordinate: each 'data' group's host actors play their own
        # episodes, and the first one's datasource is the one-device run's
        data_index = mesh.get_local_rank(cfg.data_axis)
        return _run(args, cfg, device, mesh, torch.distributed.get_rank(),
                    cfg.seed + 1000003 * data_index)
    finally:
        distributed.shutdown()


def _run(args, cfg, device, mesh, rank, seed) -> dict:
    os.makedirs(cfg.out_dir, exist_ok=True)

    from scmgan_tpu_torch.agent.play import play
    from scmgan_tpu_torch.analysis.evaluate import evaluate
    from scmgan_tpu_torch.data.datasource import allocate_datasource
    from scmgan_tpu_torch.train import checkpoint as ckpt
    from scmgan_tpu_torch.train.trainer import init_train_state, train
    from scmgan_tpu_torch.utils.timeseries import TimeSeries

    datasource = allocate_datasource(cfg.env, seed=seed, device=device)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    state = init_train_state(cfg, datasource.spec, generator)

    if cfg.load_from is None:
        print("No --load-from directory specified: initializing new networks")
    else:
        print(f"Loading models from directory {cfg.load_from}")
        state = ckpt.load_train_state(cfg.load_from, state)

    if args.student:
        from scmgan_tpu_torch.models.world_model import init_transition

        if not cfg.evaluate:
            raise SystemExit("--student serves a transition for --evaluate; "
                             "it does not train")
        with open(os.path.join(args.student, "fidelity.json")) as f:
            fid = json.load(f)
        if not fid.get("within_1pct"):
            raise SystemExit(
                f"--student {args.student}: fidelity gate FAILED "
                f"(MSE@t+10 delta {fid.get('mse10_delta_pct'):+.2f}% > 1%); "
                "refusing to serve it")
        tmpl = init_transition(torch.Generator(device=device).manual_seed(0),
                               cfg.latent_dim, datasource.spec.num_actions,
                               hidden=int(fid["hidden"]))
        student = ckpt.load_pytree(
            os.path.join(args.student, "model-transition.npz"), device, template=tmpl)
        state = dataclasses.replace(
            state, params=state.params._replace(transition=student))
        print(f"Serving distilled student transition (hidden="
              f"{fid['hidden']}, MSE@t+10 delta "
              f"{fid['mse10_delta_pct']:+.2f}%)")

    results = {}
    if cfg.evaluate:
        results["scores"] = [
            play(state.params, datasource,
                 max_steps=cfg.mpc_max_steps,
                 rollout_depth=cfg.mpc_rollout_depth,
                 lookahead=cfg.mpc_lookahead,
                 negative_positive_tradeoff=cfg.mpc_negative_tradeoff,
                 out_dir=cfg.out_dir, use_int8=args.mpc_int8,
                 rollout_samples=cfg.mpc_samples,
                 rollout_policy=cfg.mpc_policy,
                 stall_patience=cfg.mpc_stall_patience,
                 write_video=not args.no_videos)
            for _ in range(cfg.evaluations)]
        print(f"Finished {cfg.evaluations} playthroughs")
        results["evaluate"] = evaluate(
            state.params, datasource, train_iter=cfg.start_iter,
            use_training_set=True, out_dir=cfg.out_dir,
            make_videos=not args.no_videos,
            eval_batch_size=cfg.eval_batch_size,
            eval_timesteps=cfg.eval_timesteps)
        if args.causal_graph:
            from scmgan_tpu_torch.analysis.causal_graph import compute_causal_graph

            results["causal_graph"] = compute_causal_graph(
                state.params, datasource, train_iter=cfg.start_iter,
                runs=args.causal_runs, out_dir=cfg.out_dir)
        if args.higgins:
            spec = datasource.spec
            if spec.simulator is None:
                print(f"--higgins: env {spec.name!r} has no simulator")
            else:
                from scmgan_tpu_torch.analysis.higgins import (
                    higgins_metric_conv,
                    higgins_metric_spatial,
                    make_encoder_fn,
                )

                encoder_fn = make_encoder_fn(state.params.encoder)
                conv = higgins_metric_conv(
                    spec.simulator, spec.true_latent_dim, encoder_fn,
                    cfg.latent_dim, train_iters=args.higgins_iters)
                # the location-aware extension (the reference's protocol
                # cannot see same-channel spatially coded factors)
                print("spatial-moments variant:")
                spatial = higgins_metric_spatial(
                    spec.simulator, spec.true_latent_dim, encoder_fn,
                    cfg.latent_dim, train_iters=args.higgins_iters)
                results["higgins"] = {"conv": conv, "spatial": spatial}
    else:
        # under a mesh the metrics are averaged over it: the first process
        # logs them
        ts = TimeSeries("Training Model", cfg.train_iters, tensorboard=rank == 0,
                        logdir=os.path.join(cfg.out_dir, "runs"))

        def log_fn(i, metrics):
            # reading a metric waits for the card: sample every 10th
            if i % 10 == 0:
                ts.collect_dict(metrics)
            if rank == 0:
                ts.print_every(10)

        def eval_fn(state, train_iter):
            params = state.params
            if state.shardings is not None:
                from scmgan_tpu_torch.parallel.mesh import gather_pytree

                params = gather_pytree(params, state.shardings)
            if rank == 0:
                # draws from the datasource's own generator, never from the
                # one every process steps alike
                evaluate(params, datasource, train_iter=train_iter,
                         out_dir=cfg.out_dir, make_videos=not args.no_videos,
                         eval_batch_size=cfg.eval_batch_size,
                         eval_timesteps=cfg.eval_timesteps)
            if mesh is not None:
                torch.distributed.barrier()

        def checkpoint_fn(state, train_iter):
            if rank == 0:
                print("Saving networks to filesystem...")
            ckpt.save_train_state(cfg.out_dir, state)

        state = train(cfg, datasource, state, mesh_and_rules=mesh, eval_fn=eval_fn,
                      checkpoint_fn=checkpoint_fn, log_fn=log_fn,
                      generator=generator)
        ts.close()
        if rank == 0:
            print(ts)
        print("Finished")
    close = getattr(datasource, "close", None)
    if close:
        close()  # stop host-env actor threads before interpreter teardown
    print("Finished execution, terminating")
    results["state"] = state
    return results
