"""Beam-oracle control: the MPC planner with the TRUE environment as its
simulator.

Port of ``scmgan_tpu/agent/oracle.py``.  It runs the model planner's beam
(the same action table, first-action enumeration, tail policy, depth and
tradeoff weighting: agent/mpc.py, reference main.py:455-489) but simulates
futures with the real ``spec.step`` and scores with the real rewards:

  * oracle >> random  =>  planning works; the world model binds.
  * oracle ~= random  =>  no model could make this planner beat random
                          here; the planner structure binds.

The environments are batched functions of explicit state (envs/base.py), so
the oracle beam of every episode steps as one batch on the device.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from scmgan_tpu_torch.agent import mpc
from scmgan_tpu_torch.envs.base import EnvSpec, HostEnv
from scmgan_tpu_torch.utils.device import resolve_device


def oracle_rollout_scores(spec: EnvSpec, state, num_actions: int, lookahead: int = 2,
                          rollout_depth: int = 12, rollout_policy: str = "noop",
                          negative_positive_tradeoff: float = 10.0,
                          noise: Optional[mpc.PlanNoise] = None, samples: int = 1):
    """(E, A) expected best cumulative TRUE reward per first action, for the
    E environments of the batched ``state``.

    Mirrors ``mpc.rollout_reward_table`` but steps the real environment.
    ``samples`` > 1 averages over the env's own randomness (e.g. minipacman's
    ghosts), replica-major like the model beam's sampling.  Reward
    accumulation stops at episode end (done-masking).  ``noise`` draws the
    random tail and the env's step randomness (default: a generator on the
    state's device seeded with 0); the greedy policy's tail is noop here, as
    in the JAX package.
    """
    e, dev = state[0].shape[0], state[0].device
    if noise is None:
        noise = mpc.PlanNoise(torch.Generator(device=dev).manual_seed(0))
    width = num_actions ** (lookahead + 1)
    tail = (noise.tail_actions((e, width, rollout_depth - lookahead), num_actions)
            if rollout_policy == "random" else None)
    table = mpc._action_table(num_actions, lookahead, rollout_depth, rollout_policy, tail)
    table = table.to(dev).expand(e, width, rollout_depth + 1)
    wb = e * samples * width
    beam = type(state)(*(x.repeat_interleave(samples * width, dim=0) for x in state))
    cum = torch.zeros((wb, spec.num_rewards), dtype=torch.float32, device=dev)
    alive = torch.ones(wb, dtype=torch.float32, device=dev)
    for col in range(rollout_depth + 1):
        a = table[:, None, :, col].expand(e, samples, width).reshape(-1)
        beam, r, done = spec.step(beam, a, spec.draw_noise(wb, noise.generator))
        cum = cum + r.to(torch.float32) * alive[:, None]
        alive = alive * (1.0 - done.to(torch.float32))
    w = torch.ones(spec.num_rewards, dtype=torch.float32, device=dev)
    w[0] = negative_positive_tradeoff
    scores = (cum * w).sum(dim=1).reshape(e, samples, width).mean(dim=1)
    return scores.reshape(e, num_actions, -1).amax(dim=-1)


def _oracle_episodes(spec: EnvSpec, state, generator: torch.Generator, max_steps: int,
                     lookahead: int, rollout_depth: int, rollout_policy: str,
                     negative_positive_tradeoff: float, samples: int):
    """(cum_reward, steps), each (E,), of the oracle episodes that start from
    the batched ``state`` (``play_oracle``'s protocol)."""
    e, dev = state[0].shape[0], state[0].device
    noise = mpc.PlanNoise(generator)
    no_op = torch.full((e,), 3 % spec.num_actions, dtype=torch.int64, device=dev)
    for _ in range(2):
        state, _, _ = spec.step(state, no_op, spec.draw_noise(e, generator))
    cum = torch.zeros(e, dtype=torch.float32, device=dev)
    alive = torch.ones(e, dtype=torch.float32, device=dev)
    n_steps = torch.full((e,), 2, dtype=torch.int64, device=dev)
    for _ in range(2, max_steps + 1):
        scores = oracle_rollout_scores(spec, state, spec.num_actions, lookahead,
                                       rollout_depth, rollout_policy,
                                       negative_positive_tradeoff, noise=noise,
                                       samples=samples)
        state, reward_vec, done = spec.step(state, mpc.best_action(scores),
                                            spec.draw_noise(e, generator))
        cum = cum + reward_vec.to(torch.float32).sum(dim=-1) * alive
        n_steps = n_steps + alive.to(torch.int64)
        alive = alive * (1.0 - done.to(torch.float32))
    return cum, n_steps


def play_oracle_on_device(spec: EnvSpec, episodes: int = 10, max_steps: int = 300,
                          lookahead: int = 2, rollout_depth: int = 12,
                          rollout_policy: str = "noop",
                          negative_positive_tradeoff: float = 10.0,
                          samples: int = 1, seed0: int = 0, verbose: bool = True,
                          device="cuda", start_state=None):
    """Batched oracle control on ``device``; returns (rewards, steps) lists.
    A generator seeded with ``seed0`` draws the starts (unless
    ``start_state`` is given) and every later random number."""
    device = resolve_device(device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed0)
    t0 = time.time()
    if start_state is None:
        start_state = spec.reset(episodes, device, generator)
    cum, steps = _oracle_episodes(spec, start_state, generator, max_steps, lookahead,
                                  rollout_depth, rollout_policy,
                                  float(negative_positive_tradeoff), samples)
    cum, steps = cum.tolist(), steps.tolist()
    if verbose:
        print(f"play_oracle_on_device: {episodes} episodes in "
              f"{time.time() - t0:.1f}s  rewards={cum}")
    return cum, steps


def play_oracle(spec: EnvSpec, max_steps: int = 300, lookahead: int = 2,
                rollout_depth: int = 12, rollout_policy: str = "noop",
                negative_positive_tradeoff: float = 10.0, samples: int = 1,
                seed: int = 0, verbose: bool = False, device="cuda", env=None):
    """One episode planned with the true-dynamics oracle beam.

    Returns (cumulative_reward, steps).  The episode protocol of
    ``agent.play`` (3 no-op seed steps, <= max_steps, reference
    main.py:333-395), so scores are directly comparable.  ``env``: a
    ``HostEnv`` to play in (default: one seeded with ``seed``).
    """
    env = env if env is not None else HostEnv(spec, seed=seed, device=device)
    no_op = 3 % spec.num_actions
    env.reset()
    env.step(no_op)
    env.step(no_op)
    generator = torch.Generator(device=env.device)
    generator.manual_seed(seed)
    noise = mpc.PlanNoise(generator)
    cumulative = 0.0
    done = False
    t = 2
    while not done:
        scores = oracle_rollout_scores(spec, env.state, spec.num_actions, lookahead,
                                       rollout_depth, rollout_policy,
                                       negative_positive_tradeoff, noise=noise,
                                       samples=samples)[0]
        a = int(mpc.best_action(scores))
        _, reward, done, _ = env.step(a)
        cumulative += reward
        if verbose:
            print(f"t={t} a={a} r={cumulative:+.1f} "
                  + " ".join(f"{float(s):.2f}" for s in scores.cpu().numpy()))
        t += 1
        if t > max_steps:
            break
    return cumulative, t
