"""Exporter: the port's parameters -> the reference's ``.pth`` files.

Port of ``scmgan_tpu/train/torch_export.py``, the inverse of
``train/torch_import.py``: the five torch ``state_dict`` files the
reference loads with --load-from (reference main.py:85-90).  Layout
conversions mirror the importer:

  * conv w HWIO -> OIHW (permute 3, 2, 0, 1)
  * transposed-conv w HWIO -> torch's (I, O, kh, kw) (permute 2, 3, 0, 1)
  * linear w (in, out) -> (out, in)
  * spectral-norm layers -> ``convN.module.{weight_bar, bias, weight_u,
    weight_v}`` (spectral_normalization.py:47-62); u exports as it is (both
    layouts index it by output channel); v is a permutation of the port's:
    torch matricizes (O, I * kh * kw) in (I, kh, kw) order, the port in
    (kh, kw, I) order, and sigma = u . (W v) is the same under it
  * the encoder's ``bn_conv1``: the reference registers a BatchNorm it never
    calls (models.py:130,139-157); identity buffers are written so that a
    strict ``load_state_dict`` finds every key
"""

from __future__ import annotations

import os

import torch

from scmgan_tpu_torch.models.world_model import WorldModel
from scmgan_tpu_torch.train.torch_import import REFERENCE_FILES


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", torch.float32).contiguous()


def _conv_w(w):
    return _t(w.permute(3, 2, 0, 1))          # HWIO -> OIHW


def _convT_w(w):
    return _t(w.permute(2, 3, 0, 1))          # HWIO -> IOHW


def _export_layer(layer: dict, prefix: str, *, kind: str = "conv") -> dict:
    if "sn" in layer:
        w = layer["w"]
        kh, kw, ci, _ = w.shape
        v = layer["sn"]["v"].reshape(kh, kw, ci).permute(2, 0, 1).reshape(-1)
        return {f"{prefix}.module.weight_bar": _conv_w(w),
                f"{prefix}.module.bias": _t(layer["b"]),
                f"{prefix}.module.weight_u": _t(layer["sn"]["u"]),
                f"{prefix}.module.weight_v": _t(v)}
    convert = {"conv": _conv_w, "convT": _convT_w,
               "linear": lambda w: _t(w.T)}[kind]
    return {f"{prefix}.weight": convert(layer["w"]),
            f"{prefix}.bias": _t(layer["b"])}


def _bn_identity(c: int) -> dict:
    return {
        "bn_conv1.weight": torch.ones(c),
        "bn_conv1.bias": torch.zeros(c),
        "bn_conv1.running_mean": torch.zeros(c),
        "bn_conv1.running_var": torch.ones(c),
        "bn_conv1.num_batches_tracked": torch.tensor(0, dtype=torch.long),
    }


def export_encoder(p: dict) -> dict:
    sd = {}
    for name in ("conv1", "conv2", "conv3", "conv4"):
        sd.update(_export_layer(p[name], name))
    sd.update(_bn_identity(p["conv1"]["w"].shape[-1]))
    return sd


def export_transition(p: dict) -> dict:
    sd = {}
    for i in range(1, 7):
        sd.update(_export_layer(p[f"conv{i}"], f"conv{i}"))
    return sd


def export_decoder(p: dict) -> dict:
    sd = _export_layer(p["conv1"], "conv1", kind="convT")
    sd.update(_export_layer(p["conv2"], "conv2", kind="convT"))
    return sd


def export_reward_predictor(p: dict) -> dict:
    sd = _export_layer(p["conv1"], "conv1")
    sd.update(_export_layer(p["conv2"], "conv2"))
    return sd


def export_discriminator(p: dict) -> dict:
    sd = {}
    for name in ("conv1", "conv2", "conv3"):
        sd.update(_export_layer(p[name], name))
    # the importer's fc1 permutation inverted: (h, w, c) order -> torch's
    # (c, h, w) (reference models.py:221)
    w = p["fc1"]["w"]
    c = p["conv3"]["w"].shape[-1]
    s = int(round((w.shape[0] // c) ** 0.5))
    w_chw = w.reshape(s, s, c, -1).permute(2, 0, 1, 3).reshape(w.shape[0], -1)
    sd.update(_export_layer({"w": w_chw, "b": p["fc1"]["b"]}, "fc1", kind="linear"))
    return sd


_EXPORTERS = {
    "encoder": export_encoder,
    "decoder": export_decoder,
    "transition": export_transition,
    "reward_predictor": export_reward_predictor,
    "discriminator": export_discriminator,
}


def export_reference_checkpoint(params: WorldModel, out_dir: str):
    """Write the reference's five ``model-*.pth`` files from a WorldModel."""
    os.makedirs(out_dir, exist_ok=True)
    for name, fname in REFERENCE_FILES.items():
        torch.save(_EXPORTERS[name](getattr(params, name)),
                   os.path.join(out_dir, fname))
