"""The process side of the port's multi-process tests
(``tests/test_torch_parallel*.py``): spawned gloo processes that form one
group through a ``FileStore`` (several test workers may run at once, so no
TCP port is shared), make a mesh over it, run a list of jobs and write each
job's result for the parent to read.  It imports torch and the port alone,
so that a spawned process pays for no JAX import.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import time
import traceback

import numpy as np
import torch

from scmgan_tpu_torch.train.losses import LossNoise


# ---------------------------------------------------------------------------
# the loss's random draws, recorded once and replayed in every process
# ---------------------------------------------------------------------------

class RecordingNoise(LossNoise):
    """Passes ``inner``'s draws on and keeps each (kind, array), in the
    order the loss asks for them."""

    def __init__(self, inner):
        self.inner, self.draws = inner, []

    def _keep(self, kind, value):
        self.draws.append((kind, tuple(np.asarray(v) for v in value)
                           if isinstance(value, tuple) else np.asarray(value)))
        return value

    def transition(self, t, shape, dtype):
        return self._keep("transition", self.inner.transition(t, shape, dtype))

    def overshoot(self, t, shape, dtype):
        return self._keep("overshoot", self.inner.overshoot(t, shape, dtype))

    def swap_indices(self, b, latent_dim):
        return self._keep("swap_indices", self.inner.swap_indices(b, latent_dim))

    def permutation(self, b):
        return self._keep("permutation", self.inner.permutation(b))

    def rollout(self, shape, dtype):
        return self._keep("rollout", self.inner.rollout(shape, dtype))


class ReplayNoise(LossNoise):
    """Returns recorded draws in order; each call must ask for the kind and
    the (global) shape that was recorded."""

    def __init__(self, draws):
        self.draws = list(draws)

    def _next(self, kind, shape=None):
        got, value = self.draws.pop(0)
        assert got == kind, (got, kind)
        if shape is not None:
            assert value.shape == tuple(shape), (kind, value.shape, tuple(shape))
        return value

    def transition(self, t, shape, dtype):
        return torch.from_numpy(self._next("transition", shape)).to(dtype)

    def overshoot(self, t, shape, dtype):
        return torch.from_numpy(self._next("overshoot", shape)).to(dtype)

    def swap_indices(self, b, latent_dim):
        return tuple(torch.from_numpy(v) for v in self._next("swap_indices"))

    def permutation(self, b):
        return torch.from_numpy(self._next("permutation", (b,)))

    def rollout(self, shape, dtype):
        return torch.from_numpy(self._next("rollout", shape)).to(dtype)


# ---------------------------------------------------------------------------
# jobs (each runs in every process of the group)
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    from scmgan_tpu_torch.train.checkpoint import flatten_tree

    return dict(flatten_tree(tree, prefix))


def _numpy(tree) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in _flat(tree).items()}


def _world_flat(params) -> dict:
    return {f"{name}/{k}": v for name in params._fields
            for k, v in _numpy(getattr(params, name)).items()}


def sharded_step(mesh, params, cfg_kw, batch, horizon, draws, theta, cf_active):
    """One sharded train step from ``params`` (numpy) on this process's
    rows of ``batch`` with the replayed global draws.  Returns the metrics,
    this process's shards, Adam moments and their shardings, and the
    gathered (full) parameters."""
    from scmgan_tpu_torch.config import Config
    from scmgan_tpu_torch.parallel.distributed import process_batch_slice
    from scmgan_tpu_torch.parallel.mesh import gather_pytree
    from scmgan_tpu_torch.train import trainer
    from scmgan_tpu_torch.train.checkpoint import params_from_numpy

    cfg = Config(**cfg_kw)
    tp = params_from_numpy(params, device="cpu")
    state = trainer.TrainState(tp, trainer.make_optimizer(cfg, tp), 1)
    local, offset = process_batch_slice(batch[0].shape[0], mesh)
    rows = tuple(torch.from_numpy(np.asarray(x)[offset:offset + local]) for x in batch)
    step = trainer.make_train_step(cfg, horizon, mesh)
    state, metrics = step(state, rows, ReplayNoise(draws), theta, cf_active)
    specs = {f"{name}/{k}": [d for d, _ in s.sharded_dims()]
             for name in state.shardings._fields
             for k, s in _flat(getattr(state.shardings, name)).items()}
    moments = {}
    for name, opt in state.optimizers.items():
        for path, leaf in _flat(getattr(state.params, name)).items():
            st = opt.state.get(leaf)
            if st:
                moments[f"{name}/{path}"] = (st["exp_avg"].numpy().copy(),
                                             st["exp_avg_sq"].numpy().copy(),
                                             float(st["step"]))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "shards": _world_flat(state.params), "moments": moments, "specs": specs,
            "full": _world_flat(gather_pytree(state.params, state.shardings)),
            "rows": (local, offset), "step": state.step}


def checkpoint_round_trip(mesh, params, cfg_kw, out_dir):
    """A sharded state saved (counting this process's file writes) and
    loaded into a sharded template: the shards and moments it gets back."""
    from scmgan_tpu_torch.config import Config
    from scmgan_tpu_torch.parallel.mesh import shard_train_state
    from scmgan_tpu_torch.train import checkpoint as ckpt
    from scmgan_tpu_torch.train import trainer
    from scmgan_tpu_torch.train.checkpoint import params_from_numpy

    cfg = Config(**cfg_kw)
    tp = params_from_numpy(params, device="cpu")
    full = trainer.TrainState(tp, trainer.make_optimizer(cfg, tp), 3)
    rng = np.random.default_rng(0)   # the same moments in every process
    for name, opt in full.optimizers.items():
        for leaf in trainer.trainable_leaves(getattr(full.params, name)):
            opt.state[leaf] = {"step": torch.tensor(2.0),
                               "exp_avg": torch.from_numpy(rng.random(leaf.shape, np.float32)),
                               "exp_avg_sq": torch.from_numpy(rng.random(leaf.shape, np.float32))}
    state = shard_train_state(full, mesh)
    writes = []
    savez = np.savez
    np.savez = lambda f, **kw: (writes.append(os.path.basename(str(f))), savez(f, **kw))[1]
    try:
        ckpt.save_train_state(out_dir, state)
    finally:
        np.savez = savez
    fresh = shard_train_state(trainer.TrainState(
        params_from_numpy(params, device="cpu"),
        trainer.make_optimizer(cfg, params_from_numpy(params, device="cpu")), 1), mesh)
    back = ckpt.load_train_state(out_dir, fresh)
    same = []
    for name, opt in state.optimizers.items():
        mine = trainer.trainable_leaves(getattr(state.params, name))
        theirs = trainer.trainable_leaves(getattr(back.params, name))
        for a, b in zip(mine, theirs):
            sa, sb = opt.state[a], back.optimizers[name].state[b]
            same.append(torch.equal(a, b) and torch.equal(sa["exp_avg"], sb["exp_avg"])
                        and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
                        and float(sa["step"]) == float(sb["step"]))
    return {"writes": sorted(writes), "same": all(same), "n": len(same),
            "step": back.step, "sharded": back.shardings is not None}


def spatial(mesh, params, z, a):
    """This process's rows of ``spatial_transition`` on the global (z, a):
    'data' takes batch rows, 'model' takes image rows."""
    from scmgan_tpu_torch.parallel.mesh import (
        NamedSharding,
        shard_pytree,
        spatial_activation_sharding,
        spatial_transition,
        tree_map,
    )

    tp = tree_map(lambda x: torch.from_numpy(np.asarray(x)), params)
    zl = shard_pytree(torch.from_numpy(z), spatial_activation_sharding(mesh))
    al = shard_pytree(torch.from_numpy(a), NamedSharding(mesh, ("data", None)))
    with torch.no_grad():
        out = spatial_transition(tp, zl, al, mesh)
        probs = spatial_transition(tp, zl, al, mesh, sample=False)
    return {"out": out.numpy(), "probs": probs.numpy(),
            "data": mesh.get_local_rank("data"), "model": mesh.get_local_rank("model")}


def batch_slices(mesh):
    """``process_batch_slice`` of 32 rows, and the error of 33."""
    from scmgan_tpu_torch.parallel.distributed import process_batch_slice

    try:
        process_batch_slice(33, mesh)
        error = None
    except ValueError as e:
        error = str(e)
    return {"slice": process_batch_slice(32, mesh), "error": error,
            "data": mesh.get_local_rank("data"), "model": mesh.get_local_rank("model")}


class RankSource:
    """A stand-in for a host datasource (it is no ``Datasource``): the rows
    it collects differ from process to process, as a host actor's clips
    do, and each ``collect`` takes one draw of the generator, as
    ``HostReplayDatasource.collect`` does."""

    def __init__(self, rank):
        from scmgan_tpu_torch.envs import get_env

        self.spec, self.rank, self.calls = get_env("gridworld"), rank, 0
        self.device = torch.device("cpu")

    def collect(self, b, horizon, generator=None):
        seed = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator))
        self.calls += 1
        rng = np.random.default_rng([seed, self.rank])
        t, spec = horizon + 1, self.spec
        obs = rng.random((b, t, spec.height, spec.width, spec.channels)) > 0.7
        return (torch.from_numpy(obs.astype(np.float32)),
                torch.from_numpy(rng.integers(-1, 2, (b, t, spec.num_rewards))
                                 .astype(np.float32)),
                torch.from_numpy(rng.random((b, t)) > 0.9),
                torch.from_numpy(rng.integers(0, spec.num_actions, (b, t))))


def host_train(params, cfg_kw, mesh=None, rank=0):
    """``trainer.train`` from ``params`` (numpy) on a ``RankSource`` of
    ``rank``: the logged metrics, the full parameters at the end and the
    source's number of collects."""
    from scmgan_tpu_torch.config import Config
    from scmgan_tpu_torch.parallel.mesh import gather_pytree
    from scmgan_tpu_torch.train import trainer
    from scmgan_tpu_torch.train.checkpoint import params_from_numpy

    cfg = Config(**cfg_kw)
    tp = params_from_numpy(params, device="cpu")
    state = trainer.TrainState(tp, trainer.make_optimizer(cfg, tp), cfg.start_iter)
    source, logged = RankSource(rank), []
    state = trainer.train(cfg, source, state, mesh_and_rules=mesh,
                          log_fn=lambda i, m: logged.append(
                              {k: float(v) for k, v in m.items()}),
                          generator=torch.Generator().manual_seed(cfg.seed))
    params = state.params if state.shardings is None else gather_pytree(
        state.params, state.shardings)
    return {"metrics": logged, "full": _world_flat(params), "calls": source.calls}


def host_train_on_mesh(mesh, params, cfg_kw):
    return host_train(params, cfg_kw, mesh, torch.distributed.get_rank())


JOBS = {"sharded_step": sharded_step, "checkpoint_round_trip": checkpoint_round_trip,
        "spatial": spatial, "batch_slices": batch_slices,
        "host_train": host_train_on_mesh}


# ---------------------------------------------------------------------------
# the group
# ---------------------------------------------------------------------------

def _main(rank, world, shape, out_dir):
    from scmgan_tpu_torch.parallel import distributed
    from scmgan_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    results = {"seconds": {}}
    try:
        with open(os.path.join(out_dir, "jobs.pkl"), "rb") as f:
            jobs = pickle.load(f)
        t0 = time.perf_counter()
        distributed.initialize(f"file://{out_dir}/store", world, rank, backend="gloo")
        mesh = make_mesh(shape, device_type="cpu")
        results["seconds"]["group"] = time.perf_counter() - t0
        for name, job, kw in jobs:
            t0 = time.perf_counter()
            results[name] = JOBS[job](mesh, **kw)
            results["seconds"][name] = time.perf_counter() - t0
    except BaseException:
        results = {"error": traceback.format_exc()}
    finally:
        distributed.shutdown()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)


class Group:
    """``world`` spawned processes on a ``shape`` mesh running ``jobs``
    ((name, job, kwargs), ...); ``results()`` waits for them and returns
    each rank's {name: result}."""

    def __init__(self, world, shape, jobs, out_dir):
        os.makedirs(out_dir, exist_ok=True)
        # the jobs' arrays go through a file: a process's arguments pass
        # through a pipe that blocks the parent until the child has read
        # them, which would start the processes one after another
        with open(os.path.join(out_dir, "jobs.pkl"), "wb") as f:
            pickle.dump(jobs, f)
        ctx = multiprocessing.get_context("spawn")
        self.out_dir = out_dir
        self.procs = [ctx.Process(target=_main, args=(r, world, shape, out_dir))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self, timeout=240):
        out = []
        for rank, p in enumerate(self.procs):
            p.join(timeout)
            if p.is_alive():
                for q in self.procs:
                    q.kill()
                raise TimeoutError(f"rank {rank} still runs after {timeout} s")
            path = os.path.join(self.out_dir, f"rank{rank}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {rank} exited {p.exitcode} with no result")
            with open(path, "rb") as f:
                res = pickle.load(f)
            if "error" in res:
                raise RuntimeError(f"rank {rank}:\n{res['error']}")
            out.append(res)
        return out
