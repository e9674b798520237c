"""Checkpoint and exact resume.

Port of ``scmgan_tpu/train/checkpoint.py``: one flat npz per network with
path-joined keys (``conv1/w``, ``conv1/sn/u``), written and read with numpy
alone, so a bundle either package saves loads in the other
(``save_pytree`` / ``load_pytree`` / ``save_model`` / ``load_model``,
checkpoint.py:47,53,96,103); ``bundle_hash`` (:69); and the exact-resume
pair ``save_train_state`` / ``load_train_state`` (:127,135), whose
``opt_state.npz`` has optax's file layout, so that a run resumes in either
package:

    inner_states/clipped/inner_state/1/0/{count, mu/<net>/<path>, nu/<net>/<path>}
        encoder, decoder, transition (``optax.chain(clip, adam)``)
    inner_states/plain/inner_state/0/{count, mu/<net>/<path>, nu/<net>/<path>}
        reward_predictor, discriminator (``optax.adam``)

optax keeps one ``count`` per label and moments for every leaf, the
spectral-norm ``sn/u`` and ``sn/v`` included; the port keeps one
``torch.optim.Adam`` per stepped network with a ``step`` per parameter and
never steps u/v, so their moments are written as zeros and must be zero on
load.  The train step gives every parameter of a stepped network every
step (a zero gradient where the loss does not reach it, as optax does), so
a label's parameters share one count; a state that has not stepped yet is
written with zero moments and count 0.  Under
``finetune_reward`` the ``clipped`` block holds its count alone (optax masks
every network out of it, yet counts its steps), and the port has no
optimizer for those networks.  A directory holding the reference's
``model-*.pth`` files (and no ``model-encoder.npz``) loads through
``train/torch_import.py``.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from scmgan_tpu_torch.models.world_model import WorldModel
from scmgan_tpu_torch.utils.device import resolve_device

MODEL_FILES = {
    "encoder": "model-encoder.npz",
    "decoder": "model-decoder.npz",
    "transition": "model-transition.npz",
    "reward_predictor": "model-reward_predictor.npz",
    "discriminator": "model-discriminator.npz",
}
OPT_FILE = "opt_state.npz"
STEP_FILE = "step.npz"
# Each network's optax label and the path of its label's ScaleByAdamState
# (scmgan_tpu/train/trainer.py::make_optimizer).
LABELS = {"encoder": "clipped", "decoder": "clipped", "transition": "clipped",
          "reward_predictor": "plain", "discriminator": "plain"}
ADAM_PATHS = {"clipped": "inner_states/clipped/inner_state/1/0",
              "plain": "inner_states/plain/inner_state/0"}


def _to_tensor(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(device)


def flatten_tree(tree: dict, prefix: str = ""):
    """(``a/b/c`` path, leaf) for every leaf of a nested dict."""
    for key, node in tree.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            yield from flatten_tree(node, path + "/")
        else:
            yield path, node


def _unflatten(items) -> dict:
    tree: dict = {}
    for key, leaf in items:
        *parents, name = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def save_pytree(filename: str, tree: dict):
    """Nested dict of tensors -> npz with ``a/b/c`` keys."""
    np.savez(filename, **{path: leaf.detach().cpu().numpy()
                          for path, leaf in flatten_tree(tree)})


def load_pytree(filename: str, device="cuda", template: Optional[dict] = None) -> dict:
    """npz with ``a/b/c`` keys -> nested dict of tensors on ``device``.

    With ``template`` (a nested dict of tensors), only its paths are read,
    each must be in the file with the template leaf's shape, and it takes
    the template leaf's dtype (checkpoint.py:53); without, every array of
    the file is read as it is."""
    dev = resolve_device(device)
    with np.load(filename) as data:
        if template is None:
            return _unflatten((k, _to_tensor(data[k], dev)) for k in data.files)
        items = []
        for key, leaf in flatten_tree(template):
            if key not in data.files:
                raise KeyError(f"checkpoint {filename} missing {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{filename}:{key} shape {arr.shape} != "
                                 f"expected {tuple(leaf.shape)}")
            items.append((key, _to_tensor(arr, dev).to(leaf.dtype)))
    return _unflatten(items)


def bundle_hash(ckpt_dir: str, components=("encoder", "transition",
                                           "decoder", "reward_predictor")) -> str:
    """Content hash of a bundle's weights: array names, dtypes, shapes and
    raw bytes, sorted, so that it does not depend on zip metadata; the
    JAX package's value for the same files (a student's ``fidelity.json``
    records its teacher's)."""
    h = hashlib.sha256()
    for name in components:
        fname = os.path.join(ckpt_dir, MODEL_FILES[name])
        if not os.path.exists(fname):
            continue
        with np.load(fname) as data:
            for key in sorted(data.files):
                arr = np.ascontiguousarray(data[key])
                h.update(f"{name}/{key}:{arr.dtype}:{arr.shape}".encode())
                h.update(arr.tobytes())
    return h.hexdigest()[:16]


def save_model(ckpt_dir: str, params: WorldModel):
    """The five per-network files (reference main.py:136-141)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for name, fname in MODEL_FILES.items():
        save_pytree(os.path.join(ckpt_dir, fname), getattr(params, name))


def load_model(ckpt_dir: str, device="cuda",
               template: Optional[WorldModel] = None) -> WorldModel:
    """The five networks of ``ckpt_dir`` as a WorldModel on ``device``
    (checkpoint.py:103): the ``model-*.npz`` files (against ``template``'s
    paths, shapes and dtypes where one is given), or, where the directory
    has no ``model-encoder.npz`` but the reference's ``model-encoder.pth``,
    the reference's five ``.pth`` files (``load_reference_checkpoint``)."""
    dev = resolve_device(device)
    files = os.listdir(ckpt_dir)
    if MODEL_FILES["encoder"] not in files and "model-encoder.pth" in files:
        from scmgan_tpu_torch.train.torch_import import load_reference_checkpoint

        return load_reference_checkpoint(ckpt_dir, device=dev)
    missing = [f for f in MODEL_FILES.values() if f not in files]
    if missing:
        raise ValueError(
            f"Failed to load saved models from directory {ckpt_dir}: "
            f"missing {missing}")
    return WorldModel(**{
        name: load_pytree(os.path.join(ckpt_dir, fname), dev,
                          None if template is None else getattr(template, name))
        for name, fname in MODEL_FILES.items()
    })


def params_from_numpy(tree, device="cuda") -> WorldModel:
    """The JAX package's parameters, as a numpy pytree (its ``WorldModel``
    NamedTuple, or a dict with the five network names), as the port's."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    get = tree.__getitem__ if isinstance(tree, dict) else tree.__getattribute__
    return WorldModel(**{name: convert(get(name)) for name in MODEL_FILES})


def params_to_numpy(params: WorldModel) -> dict:
    """The inverse of ``params_from_numpy``: the five networks' trees as
    numpy, keyed by network name (copies: an optimizer step does not change
    them)."""
    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return node.detach().cpu().numpy().copy()

    return {name: convert(getattr(params, name)) for name in MODEL_FILES}


def _is_sn(path: str) -> bool:
    return path.split("/")[-2:-1] == ["sn"]


def save_train_state(ckpt_dir: str, state):
    """Exact-resume checkpoint: the five networks, the optimizer state in
    optax's layout (``opt_state.npz``) and ``step.npz``."""
    save_model(ckpt_dir, state.params)
    arrays, steps = {}, {label: set() for label in ADAM_PATHS}
    for name, label in LABELS.items():
        opt = state.optimizers.get(name)
        if opt is None:
            continue   # frozen under finetune_reward: optax keeps no moments
        prefix = ADAM_PATHS[label]
        for path, leaf in flatten_tree(getattr(state.params, name)):
            adam = {} if _is_sn(path) else opt.state.get(leaf, {})
            zeros = np.zeros(tuple(leaf.shape), np.float32)
            for moment, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                arrays[f"{prefix}/{moment}/{name}/{path}"] = (
                    adam[key].detach().cpu().numpy() if key in adam else zeros)
            if not _is_sn(path):
                steps[label].add(int(adam["step"]) if "step" in adam else 0)
    if not steps["clipped"]:
        # optax counts the masked-out clipped block's steps all the same
        steps["clipped"] = set(steps["plain"])
    for label, prefix in ADAM_PATHS.items():
        if len(steps[label]) != 1:
            raise ValueError(f"the {label} networks' parameters have taken "
                             f"{sorted(steps[label])} Adam steps; optax keeps one count")
        arrays[f"{prefix}/count"] = np.asarray(steps[label].pop(), np.int32)
    np.savez(os.path.join(ckpt_dir, OPT_FILE), **arrays)
    np.savez(os.path.join(ckpt_dir, STEP_FILE),
             step=np.asarray(state.step, np.int32))


def _fresh_optimizer(like: torch.optim.Adam, leaves) -> torch.optim.Adam:
    return torch.optim.Adam(leaves, **like.defaults)


def load_train_state(ckpt_dir: str, template):
    """A ``TrainState`` from ``ckpt_dir`` (checkpoint.py:135): parameters
    against ``template``'s, on its device; one Adam for each network the
    template steps, with the template's settings and, where the directory
    has ``opt_state.npz``, ``exp_avg`` / ``exp_avg_sq`` / ``step`` for
    every parameter and the saved step.  A model-only directory resumes
    with fresh optimizers and the template's step."""
    from scmgan_tpu_torch.train.trainer import TrainState, trainable_leaves

    device = template.params.encoder["conv1"]["w"].device
    params = load_model(ckpt_dir, device, template=template.params)
    opt_path = os.path.join(ckpt_dir, OPT_FILE)
    data = np.load(opt_path) if os.path.exists(opt_path) else None
    optimizers = {}
    for name in WorldModel._fields:
        net = getattr(params, name)
        leaves = trainable_leaves(net)
        stepped = name in template.optimizers
        for leaf in leaves:
            leaf.requires_grad_(stepped)
        if not stepped:
            continue
        opt = optimizers[name] = _fresh_optimizer(template.optimizers[name], leaves)
        if data is None:
            continue
        prefix = ADAM_PATHS[LABELS[name]]
        count = float(data[f"{prefix}/count"])
        for path, leaf in flatten_tree(net):
            mu, nu = (data[f"{prefix}/{m}/{name}/{path}"] for m in ("mu", "nu"))
            if _is_sn(path):
                if mu.any() or nu.any():
                    raise ValueError(f"{opt_path}: nonzero moments for the "
                                     f"spectral-norm state {name}/{path}")
                continue
            opt.state[leaf] = {
                "step": torch.tensor(count, dtype=torch.float32),
                "exp_avg": _to_tensor(mu, device).to(leaf.dtype),
                "exp_avg_sq": _to_tensor(nu, device).to(leaf.dtype)}
    if data is None:
        step = template.step
    else:
        data.close()
        with np.load(os.path.join(ckpt_dir, STEP_FILE)) as s:
            step = int(s["step"])
    return TrainState(params, optimizers, step)
