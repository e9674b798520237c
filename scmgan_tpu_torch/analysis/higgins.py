"""The Higgins et al. beta-VAE disentanglement metric.

Port of ``scmgan_tpu/analysis/higgins.py``, protocol parity with the
reference (higgins.py:22-155): render image pairs that share exactly one
ground-truth factor with the env's ``simulator``, encode both, average
|z_left - z_right| over L = 5 draws, and train a linear classifier to
predict which factor was shared; the metric is its test accuracy.  Three
variants: flat latents (``higgins_metric``), conv latents with spatially
summed z-diffs (``higgins_metric_conv``, reference higgins.py:90-155), and
per-channel spatial moments (``higgins_metric_spatial``, an extension).

The z-diff sets come from a numpy generator, as in the JAX package.  The
classifier (one linear layer, reference higgins.py:7-15) trains with
``torch.optim.Adam`` on the CPU: it is a (features x factors) matrix, far
below what a card launch is worth.  Its minibatch indices come from
``indices(i, batch, n)``: by default a torch generator seeded with the
metric's seed; a test replays the JAX package's ``fold_in`` draws.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from scmgan_tpu_torch.utils.device import no_tf32


def torch_indices(seed: int) -> Callable[[int, int, int], np.ndarray]:
    """The default minibatch source: ``batch`` uniform indices in [0, n)
    from a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def draw(i: int, batch: int, n: int) -> np.ndarray:
        return torch.randint(0, n, (batch,), generator=gen).numpy()

    return draw


def _train_classifier(z_diffs: np.ndarray, labels: np.ndarray, num_classes: int,
                      train_iters: int, indices: Callable, lr: float = 1e-3):
    """Linear softmax classifier on z-diff vectors; returns (w, b) as f32
    numpy arrays."""
    x_all = torch.as_tensor(z_diffs, dtype=torch.float32)
    y_all = torch.as_tensor(labels, dtype=torch.int64)
    dim = x_all.shape[-1]
    w = torch.zeros((dim, num_classes), requires_grad=True)
    b = torch.zeros((num_classes,), requires_grad=True)
    opt = torch.optim.Adam([w, b], lr=lr)
    n = x_all.shape[0]
    batch = min(256, n)
    with no_tf32():
        for i in range(train_iters):
            idx = torch.from_numpy(np.array(indices(i, batch, n), dtype=np.int64))
            opt.zero_grad(set_to_none=True)
            logits = x_all[idx] @ w + b
            loss = torch.nn.functional.cross_entropy(logits, y_all[idx])
            loss.backward()
            opt.step()
    return w.detach().numpy(), b.detach().numpy()


def _moment_features(z: np.ndarray) -> np.ndarray:
    """(B, H, W, C) conv latents -> (B, C*3) per-channel spatial moments:
    total mass, centroid-y, centroid-x (centroids normalized to [0, 1]).

    The reference's conv protocol reduces |dz| with a spatial sum
    (higgins.py:121-122), which cannot see where activation moved; the
    moments keep the location that this architecture codes factors by."""
    zf = np.abs(z.astype(np.float32))
    m = zf.sum(axis=(1, 2))                                   # (B, C)
    h, w = zf.shape[1:3]
    ys = np.arange(h, dtype=np.float32)[None, :, None, None]
    xs = np.arange(w, dtype=np.float32)[None, None, :, None]
    denom = np.maximum(m, 1e-6)
    cy = (zf * ys).sum(axis=(1, 2)) / denom / max(h - 1, 1)
    cx = (zf * xs).sum(axis=(1, 2)) / denom / max(w - 1, 1)
    return np.concatenate([m, cy, cx], axis=-1)


def _collect_z_diffs(simulator, encoder_fn, true_latent_dim: int,
                     encoded_latent_dim: int, batches: int, batch_size: int,
                     rng: np.random.Generator, conv: bool, L: int = 5,
                     spatial_moments: bool = False):
    """The (num_samples, encoded_latent_dim) z-diff dataset and its labels
    (reference generate_equivariance_test_batch, higgins.py:35-56): each
    pair of factor vectors shares exactly one randomly chosen factor.
    ``encoder_fn`` maps numpy frames to numpy latents."""
    all_diffs, all_labels = [], []
    for _ in range(batches):
        y = rng.integers(0, true_latent_dim, size=batch_size)
        diffs = np.zeros((L, batch_size, encoded_latent_dim), np.float32)
        for l in range(L):
            factors = rng.uniform(size=(batch_size, 2, true_latent_dim))
            factors[np.arange(batch_size), 0, y] = factors[
                np.arange(batch_size), 1, y]
            left = np.asarray(simulator(factors[:, 0]), np.float32)
            right = np.asarray(simulator(factors[:, 1]), np.float32)
            zl = np.asarray(encoder_fn(left))
            zr = np.asarray(encoder_fn(right))
            if spatial_moments:
                d = np.abs(_moment_features(zl) - _moment_features(zr))
            else:
                d = np.abs(zl - zr)
                if conv:
                    # conv latents: sum over the spatial dims (higgins.py:121-122)
                    d = d.sum(axis=(1, 2))
            diffs[l] = d.reshape(batch_size, -1)
        all_diffs.append(diffs.mean(axis=0))
        all_labels.append(y)
    return np.concatenate(all_diffs), np.concatenate(all_labels)


def higgins_metric(simulator: Callable, true_latent_dim: int,
                   encoder_fn: Callable, encoded_latent_dim: int,
                   batch_size: int = 32, train_iters: int = 200,
                   seed: int = 0, conv: bool = False, test_batches: int = 8,
                   spatial_moments: bool = False,
                   indices: Optional[Callable] = None) -> float:
    """Test accuracy of the factor classifier (the metric).  ``indices``:
    the classifier's minibatch source (default ``torch_indices(seed)``)."""
    rng = np.random.default_rng(seed)
    n_batches = max(4, train_iters // 20)
    z_diffs, labels = _collect_z_diffs(
        simulator, encoder_fn, true_latent_dim, encoded_latent_dim,
        n_batches, batch_size, rng, conv, spatial_moments=spatial_moments)
    # per-feature scale for the moments (mass ~ O(HW), centroids in [0, 1])
    scale = z_diffs.std(axis=0, keepdims=True) + 1e-8 \
        if spatial_moments else z_diffs.std() + 1e-8
    w, b = _train_classifier(z_diffs / scale, labels, true_latent_dim, train_iters,
                             indices if indices is not None else torch_indices(seed))
    zt, yt = _collect_z_diffs(
        simulator, encoder_fn, true_latent_dim, encoded_latent_dim,
        test_batches, batch_size, rng, conv, spatial_moments=spatial_moments)
    logits = torch.as_tensor(zt / scale, dtype=torch.float32) @ torch.from_numpy(w) \
        + torch.from_numpy(b)
    acc = float((logits.argmax(-1).numpy() == yt).mean())
    print(f"Higgins metric test accuracy: {acc:.4f}")
    return acc


def make_encoder_fn(encoder_params):
    """The encoder adapter of the Higgins protocols: numpy frames on the
    host -> numpy latents, encoded on the encoder's device in f32 with TF32
    off; a single-frame render (B, H, W, C) is tiled into the encoder's
    three-frame window (reference models.py:19)."""
    from scmgan_tpu_torch.models.world_model import encode

    device = encoder_params["conv1"]["w"].device

    def encoder_fn(images):
        x = torch.as_tensor(np.asarray(images, np.float32), device=device)
        if x.ndim == 4:
            x = x[:, None].repeat(1, 3, 1, 1, 1)
        with torch.inference_mode(), no_tf32():
            return encode(encoder_params, x).cpu().numpy()

    return encoder_fn


def higgins_metric_conv(simulator, true_latent_dim, encoder_fn,
                        encoded_latent_dim, batch_size: int = 16,
                        train_iters: int = 100, seed: int = 0,
                        indices: Optional[Callable] = None) -> float:
    """Conv-latent variant (reference higgins.py:90-155): z-diffs are summed
    over the spatial dimensions of the latent map before classification."""
    return higgins_metric(simulator, true_latent_dim, encoder_fn,
                          encoded_latent_dim, batch_size=batch_size,
                          train_iters=train_iters, seed=seed, conv=True,
                          indices=indices)


def higgins_metric_spatial(simulator, true_latent_dim, encoder_fn,
                           num_channels: int, batch_size: int = 16,
                           train_iters: int = 200, seed: int = 0,
                           indices: Optional[Callable] = None) -> float:
    """Location-aware conv-latent variant (an extension of the reference):
    the classifier reads |moment(z_l) - moment(z_r)| on per-channel spatial
    moments (mass, centroid-y, centroid-x), the protocol otherwise the
    same."""
    return higgins_metric(simulator, true_latent_dim, encoder_fn,
                          num_channels * 3, batch_size=batch_size,
                          train_iters=train_iters, seed=seed,
                          spatial_moments=True, indices=indices)
