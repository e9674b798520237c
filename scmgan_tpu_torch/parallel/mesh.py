"""Device mesh and sharding rules: data parallelism over the batch and
tensor parallelism over the parameters' channel axis.

Port of ``scmgan_tpu/parallel/mesh.py``.  The JAX package builds a
``Mesh(('data', 'model'))`` over one process's devices and lets GSPMD insert
the collectives; the port runs one process per device (``torchrun``, see
``parallel/distributed.py``), builds a ``DeviceMesh`` over the process
group, and writes the collectives of its train step by hand:

  * the parameters and their Adam moments are stored sharded over 'model'
    by ``leaf_spec`` (the same shape rule, mesh.py:49);
  * at the start of a step every 'model'-sharded leaf is gathered in one
    flattened all-gather; its backward keeps this process's slice, since
    the processes of a 'model' group compute the same forward on the same
    rows (a reduce-scatter there would multiply the gradient by M);
  * after ``backward`` the gradients are averaged over 'data' in one
    flattened all-reduce, before the value clip, so that the clip sees the
    global gradient as optax's does;
  * Adam steps the shards (Adam is element-wise, so this is the full step);
  * the spectral norms are refreshed on the gathered weights and each
    process keeps its slice of u and v;
  * the metrics are averaged over 'data'.

So 'model' shards the parameters and optimizer state, not the convs'
compute: every process of a 'model' group runs the whole conv.  Splitting
the convs by output channel (an activation all-gather whose backward is a
reduce-scatter) is a speed change for a machine with several cards (ROADMAP
Queue 2); GSPMD may split them, with the same numbers.

Rules (shape-based, so the same rule shards parameters, Adam moments and
any other parameter-shaped leaf):
  * 4-D HWIO conv kernels: out-channel (last) dim over 'model'
  * 2-D (in, out) linear weights: out dim over 'model'
  * 1-D vectors (biases, SN u/v): over 'model'
  * everything else (scalars, counts): replicated
  * batch leaves: leading dim over 'data'
a dim is only sharded when divisible by the axis size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Tuple[str, str] = ("data", "model"),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A 2-axis ``DeviceMesh`` over every process of the group (mesh.py:33).
    Default: all processes on 'data'.  ``device_type`` is ``cuda`` or
    ``cpu`` (by default ``cuda`` under NCCL or, with no group yet, where a
    card is available).  A plain process with ``shape`` (1, 1) makes its own
    one-process group, as a JAX mesh over one device needs no coordinator.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (world, 1)
    shape = tuple(int(n) for n in shape)
    if shape[0] * shape[1] != world:
        raise ValueError(
            f"mesh {shape[0]}x{shape[1]} needs {shape[0] * shape[1]} processes; "
            f"WORLD_SIZE is {world} (launch one process per device, e.g. "
            f"torchrun --nproc-per-node {shape[0] * shape[1]})")
    if device_type is None:
        if dist.is_initialized():
            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        else:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), world_size=1, rank=0)
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This process's coordinate on ``axis``."""
    return mesh.get_local_rank(axis)


def leaf_spec(shape: Tuple[int, ...], model_size: int,
              model_axis: str = "model") -> Optional[int]:
    """The dimension of a parameter-like leaf to shard over ``model_axis``
    (mesh.py:49), or None for a replicated leaf.  The port keeps HWIO
    kernels and (in, out) linears, so the dimension is always the last."""
    if model_size <= 1 or len(shape) == 0:
        return None
    last = shape[-1]
    if last % model_size != 0 or last < model_size:
        return None
    if len(shape) in (4, 2, 1):
        return len(shape) - 1
    return None


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """How one leaf lies on the mesh: ``spec[d]`` names the mesh axis that
    splits dimension d, or None (``jax.sharding.NamedSharding``'s
    ``PartitionSpec``)."""

    mesh: DeviceMesh
    spec: Tuple[Optional[str], ...]

    def sharded_dims(self):
        return [(d, axis) for d, axis in enumerate(self.spec) if axis is not None]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    NamedTuples (a ``WorldModel``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def mesh_of(shardings) -> DeviceMesh:
    """The mesh of a tree of ``NamedSharding``s."""
    return tree_leaves(shardings)[0].mesh


def param_shardings(tree, mesh: DeviceMesh, model_axis: str = "model"):
    """A ``NamedSharding`` for each leaf of a parameter tree (mesh.py:65)."""
    model_size = axis_size(mesh, model_axis)

    def spec(leaf):
        dim = leaf_spec(tuple(leaf.shape), model_size, model_axis)
        return NamedSharding(mesh, tuple(model_axis if d == dim else None
                                         for d in range(leaf.dim())))

    return tree_map(spec, tree)


def batch_shardings(batch, mesh: DeviceMesh, data_axis: str = "data"):
    """Every batch leaf split over ``data_axis`` on its leading dim."""
    return tree_map(lambda leaf: NamedSharding(mesh, (data_axis,)), batch)


def _local(leaf: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    for d, axis in sharding.sharded_dims():
        n = axis_size(sharding.mesh, axis)
        size = leaf.shape[d] // n
        leaf = leaf.narrow(d, axis_index(sharding.mesh, axis) * size, size)
    return leaf


def shard_pytree(tree, shardings):
    """This process's shard of every leaf (a copy where the leaf is split;
    the leaf itself where it is replicated)."""
    def place(leaf, sharding):
        if not sharding.sharded_dims():
            return leaf
        return _local(leaf.detach(), sharding).clone()

    return tree_map(place, tree, shardings)


def gather_pytree(tree, shardings):
    """The full value of every leaf, on every process (a collective: every
    process of the mesh calls it).  The split leaves come back as new
    tensors, through which no gradient flows, the replicated ones as they
    are.  One flattened all-gather per mesh axis and dtype, whatever the
    number of leaves."""
    out = tree_leaves(tree)
    specs = tree_leaves(shardings)
    if not any(s.sharded_dims() for s in specs):
        return tree
    mesh = specs[0].mesh
    for axis in mesh.mesh_dim_names:
        split = {}
        for i, s in enumerate(specs):
            for d, a in s.sharded_dims():
                if a == axis:
                    split.setdefault(out[i].dtype, []).append((i, d))
        group = mesh.get_group(axis)
        for dtype, leaves in split.items():
            shards = [out[i].detach() for i, _ in leaves]
            flat = torch.cat([x.reshape(-1) for x in shards])
            parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, flat, group=group)
            off = 0
            for (i, d), x in zip(leaves, shards):
                k = x.numel()
                out[i] = torch.cat([p[off:off + k].view(x.shape) for p in parts], dim=d)
                off += k
    it = iter(out)
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# the train state and the sharded train step
# ---------------------------------------------------------------------------

def shard_train_state(state, mesh: DeviceMesh, model_axis: str = "model"):
    """A full ``TrainState`` laid out on the mesh: each process keeps its
    shard of every parameter and of its Adam moments, with one Adam per
    stepped network over the shards."""
    from scmgan_tpu_torch.train.trainer import TrainState, trainable_leaves

    shardings = param_shardings(state.params, mesh, model_axis)
    params = shard_pytree(state.params, shardings)
    optimizers = {}
    for name, opt in state.optimizers.items():
        full = trainable_leaves(getattr(state.params, name))
        local = trainable_leaves(getattr(params, name))
        specs = trainable_leaves(getattr(shardings, name))
        for leaf in local:
            leaf.requires_grad_(True)
        new = optimizers[name] = torch.optim.Adam(local, **opt.defaults)
        for f, s, sh in zip(full, local, specs):
            st = opt.state.get(f)
            if st:
                new.state[s] = {k: (v.clone() if k == "step" else _local(v, sh).clone())
                                for k, v in st.items()}
    return TrainState(params, optimizers, state.step, shardings)


def gather_train_state(state):
    """The full ``TrainState`` of a sharded one, on every process (a
    collective): the parameters and every Adam moment gathered."""
    from scmgan_tpu_torch.train.trainer import TrainState, trainable_leaves

    # the parameters and every moment in one gather: [(params, moments)]
    moments, moment_specs = [], []
    for name, opt in state.optimizers.items():
        local = trainable_leaves(getattr(state.params, name))
        specs = trainable_leaves(getattr(state.shardings, name))
        for s, sh in zip(local, specs):
            for k, v in opt.state.get(s, {}).items():
                if k != "step":
                    moments.append(v)
                    moment_specs.append(sh)
    params, moments = tree_map(lambda x: x.detach(), gather_pytree(
        (state.params, moments), (state.shardings, moment_specs)))
    moments = iter(moments)
    optimizers = {}
    for name, opt in state.optimizers.items():
        local = trainable_leaves(getattr(state.params, name))
        full = trainable_leaves(getattr(params, name))
        for leaf in full:
            leaf.requires_grad_(True)
        new = optimizers[name] = torch.optim.Adam(full, **opt.defaults)
        for s, f in zip(local, full):
            st = opt.state.get(s)
            if st:
                new.state[f] = {k: (v.clone() if k == "step" else next(moments))
                                for k, v in st.items()}
    return TrainState(params, optimizers, state.step)


class ShardedStep:
    """The collectives of one sharded train step over ``shardings`` (the
    train state's): the trainer's step calls them around its loss,
    backward, Adam and spectral-norm refresh."""

    def __init__(self, mesh: DeviceMesh, shardings, data_axis: str = "data",
                 model_axis: str = "model"):
        self.mesh, self.shardings = mesh, shardings
        self.data_axis, self.model_axis = data_axis, model_axis
        self.data_size = axis_size(mesh, data_axis)
        # (leaf index, sharded dim) of every 'model'-sharded leaf
        self._sharded = [(i, s.sharded_dims()[0][0])
                         for i, s in enumerate(tree_leaves(shardings)) if s.sharded_dims()]
        self._pairs = []

    def gather(self, params):
        """The full parameters for the forward (``gather_pytree``).  Each
        gathered leaf is a leaf of the step's graph, so that autograd sums
        its gradient's contributions in the order it sums a one-device
        parameter's (``shard_grads`` then keeps this process's slice)."""
        if not self._sharded:
            return params
        full = gather_pytree(params, self.shardings)
        shards, gathered = tree_leaves(params), tree_leaves(full)
        self._pairs = []
        for i, d in self._sharded:
            if shards[i].requires_grad:
                gathered[i].requires_grad_(True)
                self._pairs.append((shards[i], gathered[i], d))
        return full

    def shard_grads(self):
        """The backward of the gather: each shard's gradient is this
        process's slice of its gathered leaf's; the processes of a 'model'
        group computed the same forward on the same rows, so the slices
        add up to the full gradient, with no reduction."""
        index = axis_index(self.mesh, self.model_axis)
        for shard, f, d in self._pairs:
            if f.grad is not None:
                size = shard.shape[d]
                shard.grad = f.grad.narrow(d, index * size, size).contiguous()
        self._pairs = []

    def reduce_grads(self, tensors):
        """Average the gradients of ``tensors`` over 'data', in one
        flattened all-reduce."""
        if self.data_size == 1:
            return
        grads = [t.grad for t in tensors]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.get_group(self.data_axis))
        flat.div_(self.data_size)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()

    def refresh_spectral_norms(self, params):
        """The spectral-norm refresh on the gathered (stepped) weights;
        returns the shard tree with this process's slice of each new u/v."""
        from scmgan_tpu_torch.ops.spectral_norm import update_spectral_norms

        with torch.no_grad():
            fresh = update_spectral_norms(
                gather_pytree(params, self.shardings) if self._sharded else params)
        if not self._sharded:
            return fresh

        def keep(node, full, specs):
            if not isinstance(node, dict):
                return node
            out = {k: keep(v, full[k], specs[k]) for k, v in node.items()}
            if "sn" in node and "w" in node:
                out["sn"] = {k: _local(full["sn"][k], specs["sn"][k]).clone()
                             if specs["sn"][k].sharded_dims() else full["sn"][k]
                             for k in ("u", "v")}
            return out

        return type(params)(*(keep(n, f, s) for n, f, s
                              in zip(params, fresh, self.shardings)))

    def mean_metrics(self, metrics: dict) -> dict:
        """The metrics averaged over 'data' (JAX's are replicated)."""
        if self.data_size == 1:
            return metrics
        keys = sorted(metrics)
        flat = torch.stack([metrics[k].to(torch.float32) for k in keys])
        dist.all_reduce(flat, group=self.mesh.get_group(self.data_axis))
        flat.div_(self.data_size)
        return dict(zip(keys, flat.unbind()))


def shard_train_step(step_fn, mesh: DeviceMesh, data_axis: str = "data",
                     model_axis: str = "model"):
    """The sharded form of a train step (mesh.py:84).

    Returned fn(state, batch, noise, theta, cf_active) -> (state, metrics):
    ``batch`` holds this process's rows (``process_batch_slice``), and
    ``noise`` draws the GLOBAL batch's numbers (every process seeds it
    alike); the step keeps this process's rows of each draw.  A full state
    is laid out on the mesh at the first call (``shard_train_state``), as
    JAX's jit places it by its in_shardings; the returned state stays
    sharded.  ``step_fn`` is the trainer's step, which takes the
    collectives as ``sharded=``.
    """
    from scmgan_tpu_torch.train.losses import ShardedLossNoise

    data_size = axis_size(mesh, data_axis)
    sharded = None

    def wrapper(state, batch, noise, theta, cf_active):
        nonlocal sharded
        if state.shardings is None:
            state = shard_train_state(state, mesh, model_axis)
        if sharded is None or sharded.shardings is not state.shardings:
            # a state laid out anew (a first call, a resume)
            sharded = ShardedStep(mesh, state.shardings, data_axis, model_axis)
        if data_size > 1:
            local = batch[0].shape[0]
            noise = ShardedLossNoise(noise, axis_index(mesh, data_axis) * local, local,
                                     local * data_size, mesh.get_group(data_axis))
        return step_fn(state, batch, noise, theta, cf_active, sharded=sharded)

    return wrapper


def share_model_batch(batch, generator: torch.Generator, mesh: DeviceMesh,
                      model_axis: str = "model"):
    """The batch that the first process of this process's 'model' group
    collected, on every process of the group (a collective), and that
    process's ``generator`` state, so that the group's generators stay in
    step.  The first process passes its batch, the others None.

    A host datasource's clips depend on its actors' timing, so the
    processes of one 'model' group cannot collect the same rows each: the
    first collects them and the others receive them, as ``shard_grads``
    requires.
    """
    group = mesh.get_group(model_axis)
    if dist.get_world_size(group) == 1:
        return batch
    src = dist.get_global_rank(group, 0)
    first = mesh.get_local_rank(model_axis) == 0
    meta = [([(tuple(x.shape), x.dtype) for x in batch], generator.get_state())
            if first else None]
    dist.broadcast_object_list(meta, src=src, group=group)
    shapes, state = meta[0]
    if not first:
        generator.set_state(state)
        batch = tuple(torch.empty(shape, dtype=dtype, device=generator.device)
                      for shape, dtype in shapes)
    for x in batch:
        # gloo broadcasts no bool: the same bytes as uint8
        dist.broadcast(x.view(torch.uint8) if x.dtype == torch.bool else x, src=src,
                       group=group)
    return batch


# ---------------------------------------------------------------------------
# spatial partitioning
# ---------------------------------------------------------------------------

def spatial_activation_sharding(mesh: DeviceMesh, data_axis: str = "data",
                                spatial_axis: str = "model") -> NamedSharding:
    """The sharding of (B, H, W, C) activations with the batch split over
    ``data_axis`` and the image height over ``spatial_axis`` (mesh.py:126):
    ``shard_pytree`` places a latent so, and ``spatial_transition`` steps
    it.  Where GSPMD inserts the halo exchanges, ``spatial_transition``
    makes them itself."""
    return NamedSharding(mesh, (data_axis, spatial_axis, None, None))


def _halo_rows(x: torch.Tensor, group) -> torch.Tensor:
    """x (B, h, W, C), this process's rows of a torus, with one row of each
    ring neighbour on either side: (B, h + 2, W, C).  A process that is its
    own neighbour (a ring of one) wraps its own rows."""
    n = dist.get_world_size(group)
    if n == 1:
        return torch.cat([x[:, -1:], x, x[:, :1]], dim=1)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    top = torch.empty_like(x[:, :1]).contiguous()
    bottom = torch.empty_like(top)
    # tag 0 travels down the ring (a last row), tag 1 up it (a first row);
    # with two processes both neighbours are one peer, and the tags (gloo)
    # and the order of the calls (NCCL) keep the two rows apart
    ops = [dist.P2POp(dist.isend, x[:, -1:].contiguous(), nxt, group, tag=0),
           dist.P2POp(dist.isend, x[:, :1].contiguous(), prv, group, tag=1),
           dist.P2POp(dist.irecv, top, prv, group, tag=0),
           dist.P2POp(dist.irecv, bottom, nxt, group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([top, x, bottom], dim=1)


def spatial_transition(params: dict, z: torch.Tensor, action_onehot: torch.Tensor,
                       mesh: DeviceMesh, spatial_axis: str = "model",
                       sample: bool = True) -> torch.Tensor:
    """``transition(train=False)`` on this process's rows of the latent
    (``spatial_activation_sharding``): z (B_local, H / M, W, latent),
    action_onehot (B_local, A).  Before each of the six circular convs one
    halo row is exchanged with each ring neighbour over ``spatial_axis``;
    the wrap-around of the ring is the torus.  W wraps locally.  Returns
    this process's rows of the thresholded latents, or of the sigmoid
    probabilities without ``sample``."""
    from scmgan_tpu_torch.models.world_model import transition

    group = mesh.get_group(spatial_axis)

    def pad(x):
        x = _halo_rows(x, group)
        return torch.cat([x[:, :, -1:], x, x[:, :, :1]], dim=2)   # W wraps here

    return transition(params, z, action_onehot, train=not sample, deterministic=True,
                      pad=pad)
