"""Importer for the reference's ``.pth`` checkpoints.

Port of ``scmgan_tpu/train/torch_import.py``.  The reference saves five
torch ``state_dict`` files (model-{encoder,decoder,transition,
discriminator,reward_predictor}.pth, reference main.py:136-141); this
module maps them onto the port's parameter trees.  Layout conversions:

  * Conv2d weight OIHW -> HWIO (permute 2, 3, 1, 0)
  * ConvTranspose2d weight (I, O, kh, kw) -> HWIO (permute 2, 3, 0, 1);
    ``conv_transpose2d`` flips the kernel at call time, as torch's
    transposed conv does for stride 1 / padding 1
  * Linear weight (out, in) -> (in, out)
  * SpectralNorm wrapping: ``convN.module.{weight_bar, bias, weight_u}``
    (spectral_normalization.py:47-62); ``weight_bar`` is the raw ``w``,
    ``weight_u`` is taken as it is, and one power iteration of the port's
    own from that u gives (u, v) in the port's (kh, kw, I) matricization:
    the reference's first forward runs exactly that iteration before it
    computes sigma (spectral_normalization.py:29-35), and its stored v is
    overwritten before use
  * the discriminator's fc1 input axis from torch's NCHW flattening to the
    port's NHWC one

Files load with ``torch.load(..., weights_only=True)``: tensors only.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from scmgan_tpu_torch.models.world_model import WorldModel
from scmgan_tpu_torch.ops.spectral_norm import sn_power_iteration
from scmgan_tpu_torch.utils.device import resolve_device

REFERENCE_FILES = {
    "encoder": "model-encoder.pth",
    "decoder": "model-decoder.pth",
    "transition": "model-transition.pth",
    "reward_predictor": "model-reward_predictor.pth",
    "discriminator": "model-discriminator.pth",
}


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


def _conv_w(t):
    return _f32(t.permute(2, 3, 1, 0))       # OIHW -> HWIO


def _convT_w(t):
    return _f32(t.permute(2, 3, 0, 1))       # IOHW -> HWIO


def _linear_w(t):
    return _f32(t.T)                          # (out, in) -> (in, out)


def _import_layer(sd: Dict, prefix: str, *, kind: str = "conv",
                  spectral: bool = False) -> dict:
    """One conv / transposed-conv / linear layer of a reference state_dict."""
    if spectral:
        w = _conv_w(sd[f"{prefix}.module.weight_bar"])
        u = _f32(sd[f"{prefix}.module.weight_u"])
        u, v = sn_power_iteration(w, u, w.new_zeros(w.numel() // w.shape[-1]))
        return {"w": w, "b": _f32(sd[f"{prefix}.module.bias"]),
                "sn": {"u": u, "v": v}}
    convert = {"conv": _conv_w, "convT": _convT_w, "linear": _linear_w}[kind]
    return {"w": convert(sd[f"{prefix}.weight"]), "b": _f32(sd[f"{prefix}.bias"])}


def import_encoder(sd: Dict) -> dict:
    # bn_conv1 is in the state_dict but never called in the reference's
    # forward (models.py:130,139-157): skipped.
    return {
        "conv1": _import_layer(sd, "conv1", spectral=True),
        "conv2": _import_layer(sd, "conv2", spectral=True),
        "conv3": _import_layer(sd, "conv3", spectral=True),
        "conv4": _import_layer(sd, "conv4"),
    }


def import_transition(sd: Dict) -> dict:
    out = {f"conv{i}": _import_layer(sd, f"conv{i}", spectral=True)
           for i in range(1, 6)}
    out["conv6"] = _import_layer(sd, "conv6")
    return out


def import_decoder(sd: Dict) -> dict:
    return {"conv1": _import_layer(sd, "conv1", kind="convT"),
            "conv2": _import_layer(sd, "conv2", kind="convT")}


def import_reward_predictor(sd: Dict) -> dict:
    return {"conv1": _import_layer(sd, "conv1"),
            "conv2": _import_layer(sd, "conv2")}


def import_discriminator(sd: Dict) -> dict:
    out = {
        "conv1": _import_layer(sd, "conv1", spectral=True),
        "conv2": _import_layer(sd, "conv2", spectral=True),
        "conv3": _import_layer(sd, "conv3"),
        "fc1": _import_layer(sd, "fc1", kind="linear"),
    }
    # torch flattens conv3's output in (c, h, w) order before fc1
    # (reference models.py:221), the port in (h, w, c) order.
    w = out["fc1"]["w"]                       # (in, out), in = c * s * s
    c = out["conv3"]["w"].shape[-1]
    s = int(round((w.shape[0] // c) ** 0.5))
    out["fc1"]["w"] = w.reshape(c, s, s, -1).permute(1, 2, 0, 3).reshape(
        w.shape[0], -1).contiguous()
    return out


_IMPORTERS = {
    "encoder": import_encoder,
    "decoder": import_decoder,
    "transition": import_transition,
    "reward_predictor": import_reward_predictor,
    "discriminator": import_discriminator,
}


def load_reference_checkpoint(ckpt_dir: str, device="cuda") -> WorldModel:
    """The reference's five ``.pth`` files as a WorldModel on ``device``."""
    dev = resolve_device(device)
    parts = {}
    for name, fname in REFERENCE_FILES.items():
        sd = torch.load(os.path.join(ckpt_dir, fname), map_location="cpu",
                        weights_only=True)
        parts[name] = {layer: {k: (v.to(dev) if torch.is_tensor(v) else
                                   {kk: vv.to(dev) for kk, vv in v.items()})
                               for k, v in node.items()}
                       for layer, node in _IMPORTERS[name](sd).items()}
    return WorldModel(**parts)
