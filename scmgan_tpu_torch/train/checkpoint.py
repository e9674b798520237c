"""Saving and loading a five-network bundle.

Port of ``scmgan_tpu/train/checkpoint.py``'s ``save_pytree`` /
``load_pytree`` / ``save_model`` / ``load_model`` (checkpoint.py:47,53,96,
103): one flat npz per network with path-joined keys (``conv1/w``,
``conv1/sn/u``), written and read with numpy alone, so a bundle either
package saves loads in the other.  The optimizer-state files of
``save_train_state`` / ``load_train_state`` (exact resume) and the reference
``.pth`` import wait for ROADMAP Queue 1.4.
"""

from __future__ import annotations

import os

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


def save_pytree(filename: str, tree: dict):
    """Nested dict of tensors -> npz with ``a/b/c`` keys."""
    np.savez(filename, **{path: leaf.detach().cpu().numpy()
                          for path, leaf in flatten_tree(tree)})


def load_pytree(filename: str, device) -> dict:
    """npz with ``a/b/c`` keys -> nested dict of tensors on ``device``."""
    tree: dict = {}
    with np.load(filename) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = _to_tensor(data[key], device)
    return tree


def save_model(ckpt_dir: str, params: WorldModel):
    """The five per-network files (reference main.py:136-141)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for name, fname in MODEL_FILES.items():
        save_pytree(os.path.join(ckpt_dir, fname), getattr(params, name))


def load_model(ckpt_dir: str, device="cuda") -> WorldModel:
    """The five ``model-*.npz`` files of ``ckpt_dir`` as a WorldModel on
    ``device``, with the reference's presence check (main.py:81-83)."""
    dev = resolve_device(device)
    missing = [f for f in MODEL_FILES.values()
               if not os.path.exists(os.path.join(ckpt_dir, f))]
    if missing:
        raise ValueError(
            f"Failed to load saved models from directory {ckpt_dir}: "
            f"missing {missing}")
    return WorldModel(**{
        name: load_pytree(os.path.join(ckpt_dir, fname), dev)
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
