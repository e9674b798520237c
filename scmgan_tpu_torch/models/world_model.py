"""The world model: Encoder, Transition, Decoder, RewardPredictor,
Discriminator.

Port of ``scmgan_tpu/models/world_model.py`` as plain functions over the
same nested parameter dicts (``{"conv1": {"w": HWIO, "b": (C,), "sn":
{"u", "v"}}, ...}``), NHWC throughout: the ``init_*`` functions (drawn from
an explicit ``torch.Generator`` on the target device, with the JAX package's
tree paths, shapes and dtypes), the forwards, and the train path of
``transition`` (straight-through Bernoulli head, or the deterministic
sigmoid), and the visualize forms of ``decode`` (the first sample's
per-factor layers) and ``predict_reward`` (the signed spatial map).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from scmgan_tpu_torch.ops.conv import (
    circular_pad,
    conv2d,
    conv2d_init,
    conv_transpose2d,
    conv_transpose2d_init,
    leaky_relu,
    linear,
    linear_init,
)
from scmgan_tpu_torch.ops.spectral_norm import sn_init, sn_weight
from scmgan_tpu_torch.ops.stochastic import hard_threshold, st_bernoulli

NOISE_DIM = 3
ENCODER_INPUT_FRAMES = 3


class WorldModel(NamedTuple):
    """The five networks' parameter dicts (reference main.py:136-141)."""

    encoder: dict
    decoder: dict
    transition: dict
    reward_predictor: dict
    discriminator: dict


def _sn_conv_init(generator, in_ch, out_ch, ksize=3, dtype=torch.float32):
    p = conv2d_init(generator, in_ch, out_ch, ksize, dtype)
    p["sn"] = sn_init(generator, p["w"])
    return p


def _sn_conv(params, x, **kw):
    return conv2d(params, x, w=sn_weight(params), **kw)


def init_encoder(generator, latent_dim: int, color_channels: int,
                 hidden: int = 128, dtype=torch.float32) -> dict:
    in_ch = color_channels * ENCODER_INPUT_FRAMES
    return {
        "conv1": _sn_conv_init(generator, in_ch, hidden, 3, dtype),
        "conv2": _sn_conv_init(generator, hidden, hidden, 3, dtype),
        "conv3": _sn_conv_init(generator, hidden, hidden, 3, dtype),
        "conv4": conv2d_init(generator, hidden, latent_dim, 3, dtype),
    }


def encode(params: dict, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F=3, H, W, C) -> latent map (B, H, W, latent).

    Frames stack onto channels frame-major, as the reference's (B, F*C, H, W)
    view does (models.py:142-143).
    """
    b, f, h, w, c = frames.shape
    x = frames.permute(0, 2, 3, 1, 4).reshape(b, h, w, f * c)
    x = leaky_relu(_sn_conv(params["conv1"], x))
    x = leaky_relu(_sn_conv(params["conv2"], x))
    x = leaky_relu(_sn_conv(params["conv3"], x))
    x = conv2d(params["conv4"], x)
    return torch.sigmoid(x)


def init_transition(generator, latent_dim: int, num_actions: int,
                    hidden: int = 128, dtype=torch.float32) -> dict:
    return {
        "conv1": _sn_conv_init(generator, latent_dim + num_actions, hidden, 3,
                               dtype),
        "conv2": _sn_conv_init(generator, hidden, hidden, 3, dtype),
        "conv3": _sn_conv_init(generator, hidden, hidden, 3, dtype),
        "conv4": _sn_conv_init(generator, hidden, hidden, 3, dtype),
        "conv5": _sn_conv_init(generator, hidden + hidden, hidden, 3, dtype),
        "conv6": conv2d_init(generator, hidden + hidden, latent_dim, 3, dtype),
    }


def transition(params: dict, z: torch.Tensor, action_onehot: torch.Tensor,
               u: Optional[torch.Tensor] = None, *, train: bool = True,
               return_all: bool = False, deterministic: bool = False,
               pad: Callable[[torch.Tensor], torch.Tensor] = circular_pad):
    """One latent dynamics step.

    z: (B, H, W, latent); action_onehot: (B, A), broadcast to every pixel.
    Six circular 3x3 convs with U-Net skips (1->6, 2->5), sigmoid, then the
    head (reference models.py:43-119): with ``train`` and ``deterministic``
    the sigmoid itself; with ``train`` and uniforms ``u`` (z's shape) the
    straight-through Bernoulli sample ``u < p``; otherwise the eval-mode
    threshold at 0.5.  ``u`` stands in for the JAX function's key.
    ``pad`` gives each conv's input its one-pixel border (the torus's wrap;
    ``parallel.mesh.spatial_transition`` passes ring-neighbour halos).
    """
    b, h, w, _ = z.shape
    a_map = action_onehot[:, None, None, :].to(z.dtype).expand(
        b, h, w, action_onehot.shape[-1])
    x = torch.cat([z, a_map], dim=-1)

    x = leaky_relu(_sn_conv(params["conv1"], pad(x), padding="VALID"))
    skip1 = x
    x = leaky_relu(_sn_conv(params["conv2"], pad(x), padding="VALID"))
    skip2 = x
    x = leaky_relu(_sn_conv(params["conv3"], pad(x), padding="VALID"))
    out3 = x
    x = leaky_relu(_sn_conv(params["conv4"], pad(x), padding="VALID"))
    out4 = x
    x = torch.cat([x, skip2], dim=-1)
    x = leaky_relu(_sn_conv(params["conv5"], pad(x), padding="VALID"))
    out5 = x
    x = torch.cat([x, skip1], dim=-1)
    x = torch.sigmoid(conv2d(params["conv6"], pad(x), padding="VALID"))
    if train and deterministic:
        pass
    elif train and u is not None:
        x = st_bernoulli(u, x)
    else:
        x = hard_threshold(x)
    if return_all:
        return skip1, skip2, out3, out4, out5, x
    return x


def init_decoder(generator, latent_dim: int, color_channels: int,
                 dtype=torch.float32) -> dict:
    return {
        "conv1": conv_transpose2d_init(generator, latent_dim, latent_dim * 4,
                                       3, dtype),
        "conv2": conv_transpose2d_init(generator, latent_dim * 4,
                                       latent_dim * color_channels, 3, dtype),
    }


def decode(params: dict, z: torch.Tensor, visualize: bool = False):
    """z: (B, H, W, latent) -> pixel logits (B, H, W, color).

    Per-factor additive decoding: conv to latent*color channels, reshape to
    (..., latent, color), sum over the latent axis (reference
    models.py:279-287).  ``visualize`` also returns the first sample's
    per-factor layers (latent, H, W, color) (models.py:284-290).
    """
    latent_dim = z.shape[-1]
    color = params["conv2"]["w"].shape[-1] // latent_dim
    x = leaky_relu(conv_transpose2d(params["conv1"], z))
    x = conv_transpose2d(params["conv2"], x)
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, latent_dim, color)
    out = x.sum(dim=3)
    if visualize:
        return out, x[0].permute(2, 0, 1, 3)
    return out


def decode_fused(params: dict, z: torch.Tensor) -> torch.Tensor:
    """``decode`` with the per-factor sum folded into conv2's weights, exact
    by linearity (the serving decoder)."""
    latent_dim = z.shape[-1]
    w2 = params["conv2"]["w"]
    kh, kw, cin, lc = w2.shape
    color = lc // latent_dim
    w2s = w2.reshape(kh, kw, cin, latent_dim, color).sum(dim=3)
    b2s = params["conv2"]["b"].reshape(latent_dim, color).sum(dim=0)
    x = leaky_relu(conv_transpose2d(params["conv1"], z))
    return conv_transpose2d({"w": w2s, "b": b2s}, x)


def init_reward_predictor(generator, latent_dim: int, num_rewards: int,
                          dtype=torch.float32) -> dict:
    return {
        "conv1": conv2d_init(generator, latent_dim, 32, 3, dtype),
        "conv2": conv2d_init(generator, 32, num_rewards * 3, 3, dtype),
    }


def predict_reward(params: dict, z: torch.Tensor, visualize: bool = False):
    """z: (B, H, W, latent) -> reward vector (B, num_rewards).

    Each pixel is classified 3 ways (+1 / 0 / -1) per reward channel and the
    signed map p[+1] - p[-1] is summed over pixels (reference
    models.py:235-250).  conv1 is VALID, conv2 VALID with stride 2.
    ``visualize`` also returns the signed map (B, h, w, num_rewards).
    """
    num_rewards = params["conv2"]["w"].shape[-1] // 3
    x = leaky_relu(conv2d(params["conv1"], z, padding="VALID"))
    x = conv2d(params["conv2"], x, stride=2, padding="VALID")
    b, h, w, _ = x.shape
    # the channel axis splits 3-major: (3, num_rewards), reference models.py:243
    x = torch.softmax(x.reshape(b, h, w, 3, num_rewards), dim=3)
    signed = x[:, :, :, 0, :] - x[:, :, :, 2, :]
    total = signed.sum(dim=(1, 2))
    if visualize:
        return total, signed
    return total


def init_discriminator(generator, img_size=64, dtype=torch.float32) -> dict:
    """``img_size``: int (square) or (height, width); fc1 is sized from both
    spatial dims after three stride-2 VALID 3x3 convs."""
    h, w = (img_size, img_size) if isinstance(img_size, int) else img_size
    for _ in range(3):
        h = (h - 3) // 2 + 1
        w = (w - 3) // 2 + 1
    return {
        "conv1": _sn_conv_init(generator, NOISE_DIM, 32, 3, dtype),
        "conv2": _sn_conv_init(generator, 32, 32, 3, dtype),
        "conv3": conv2d_init(generator, 32, 32, 3, dtype),
        "fc1": linear_init(generator, 32 * h * w, 1, dtype),
    }


def discriminate(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, NOISE_DIM) noise map -> (B, 1) logit (reference
    models.py:208-223)."""
    x = leaky_relu(_sn_conv(params["conv1"], x, stride=2, padding="VALID"))
    x = leaky_relu(_sn_conv(params["conv2"], x, stride=2, padding="VALID"))
    x = leaky_relu(conv2d(params["conv3"], x, stride=2, padding="VALID"))
    return leaky_relu(linear(params["fc1"], x.reshape(x.shape[0], -1)))


def init_world_model(generator: torch.Generator, latent_dim: int,
                     num_actions: int, num_rewards: int, input_channels: int,
                     output_channels: int, hidden: int = 128, img_size=64,
                     dtype=torch.float32) -> WorldModel:
    """The five networks, drawn in order from ``generator`` on its device."""
    return WorldModel(
        encoder=init_encoder(generator, latent_dim, input_channels, hidden,
                             dtype),
        decoder=init_decoder(generator, latent_dim, output_channels, dtype),
        transition=init_transition(generator, latent_dim, num_actions, hidden,
                                   dtype),
        reward_predictor=init_reward_predictor(generator, latent_dim,
                                               num_rewards, dtype),
        discriminator=init_discriminator(generator, img_size, dtype),
    )
