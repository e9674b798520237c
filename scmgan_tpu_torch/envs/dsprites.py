"""dSprites factor images for the Higgins metric.

Port of ``scmgan_tpu/envs/dsprites.py``, numpy only (the port keeps its own
copy).  The reference loads the dSprites npz from a private NFS path
(reference envs/dsprites.py:6-21) and exposes four ground-truth factors,
scale, orientation, posX and posY, with the shape fixed to the square
(reference envs/dsprites.py:24-41).

``init(path)`` loads the npz from ``path``, ``SCMGAN_DSPRITES_PATH`` or the
reference's default path.  Without the file the images are rendered on the
documented factor grid instead:

  * scale        in linspace(0.5, 1.0, 6)
  * orientation  in linspace(0, 2*pi, 40)
  * posX, posY   in linspace(0, 1, 32)
  * shape        square / ellipse / heart (the npz's 3 shapes; the
                 reference protocol uses only shape 0)

by a 4x4-supersampled binary rasterization of each shape's implicit form
(base size 30 px at scale 1, centres spanning [16, 48] px), the JAX
package's renderer: the original rasterizer is not public, so it is not
bit-exact against the npz, and the file, when present, is used instead.
The loaded images are module state, as in the JAX module.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

NUM_FACTORS = 4
IMG_WIDTH = 64
NUM_SHAPES = 3
SCALES = np.linspace(0.5, 1.0, 6)
ORIENTATIONS = np.linspace(0.0, 2 * np.pi, 40)
POSITIONS = np.linspace(0.0, 1.0, 32)

_BASE_SIZE = 30.0        # px at scale 1.0
_POS_LO, _POS_HI = 16.0, 48.0   # object-center span in px
_SS = 4                  # supersampling factor

_DEFAULT_PATH = "/mnt/nfs/data/dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"

_imgs: Optional[np.ndarray] = None
_loaded_from_file = False


def init(path: Optional[str] = None):
    """Load the dSprites npz if present; otherwise mark regeneration mode."""
    global _imgs, _loaded_from_file
    path = path or os.environ.get("SCMGAN_DSPRITES_PATH", _DEFAULT_PATH)
    if os.path.exists(path):
        with np.load(path, encoding="bytes") as npz:
            _imgs = npz["imgs"]
        _loaded_from_file = True
    else:
        _imgs = None
        _loaded_from_file = False


def _shape_mask(shape: int, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Inside-test in the shape's canonical frame, unit half-width.

    xs, ys: coordinates already translated/rotated/scaled so the shape's
    bounding half-extent is 1.  Returns a boolean array.
    """
    if shape == 0:      # square
        return (np.abs(xs) <= 1.0) & (np.abs(ys) <= 1.0)
    if shape == 1:      # ellipse, 2:1 aspect like the npz's
        return (xs ** 2) + (ys / 0.5) ** 2 <= 1.0
    # heart: classic sextic (x^2 + y^2 - 1)^3 - x^2 y^3 <= 0, y up,
    # scaled by 1/1.3 to fill the unit box
    hx = xs / 0.77
    hy = -ys / 0.77
    return (hx ** 2 + hy ** 2 - 1.0) ** 3 - (hx ** 2) * (hy ** 3) <= 0.0


def render(scale_idx: int, orient_idx: int, x_idx: int, y_idx: int,
           shape: int = 0) -> np.ndarray:
    """One (64, 64) float binary image from grid indices."""
    size = _BASE_SIZE * SCALES[int(scale_idx)]
    theta = ORIENTATIONS[int(orient_idx)]
    cx = _POS_LO + POSITIONS[int(x_idx)] * (_POS_HI - _POS_LO)
    cy = _POS_LO + POSITIONS[int(y_idx)] * (_POS_HI - _POS_LO)

    n = IMG_WIDTH * _SS
    coords = (np.arange(n, dtype=np.float32) + 0.5) / _SS
    yy, xx = np.meshgrid(coords, coords, indexing="ij")
    dx, dy = xx - cx, yy - cy
    c, s = np.cos(theta), np.sin(theta)
    rx = (c * dx + s * dy) / (size / 2.0)
    ry = (-s * dx + c * dy) / (size / 2.0)
    fine = _shape_mask(int(shape), rx, ry)
    coverage = fine.reshape(IMG_WIDTH, _SS, IMG_WIDTH, _SS).mean(axis=(1, 3))
    return (coverage > 0.5).astype(np.float32)


def generate_image_discrete(factors, shape: int = 0) -> np.ndarray:
    """factors: [scale(0-5), orientation(0-39), x(0-31), y(0-31)]
    (reference envs/dsprites.py:31-41; npz index order scale-major,
    shape fixed at 0 there)."""
    scale, orientation, x, y = (int(f) for f in factors)
    if _imgs is None and not _loaded_from_file:
        init()
    if _imgs is not None:
        idx = (y + x * 32 + orientation * 32 * 32
               + scale * 32 * 32 * 40 + shape * 32 * 32 * 40 * 6)
        return _imgs[idx]
    return render(scale, orientation, x, y, shape)


def generate_image_continuous(factors) -> np.ndarray:
    """factors in [0,1]^4 (reference envs/dsprites.py:44-51)."""
    discrete = [
        min(int(factors[0] * 6), 5),
        min(int(factors[1] * 40), 39),
        min(int(factors[2] * 32), 31),
        min(int(factors[3] * 32), 31),
    ]
    return generate_image_discrete(discrete)


def normalize_factors(factors):
    """Grid indices -> [0,1] targets (reference envs/dsprites.py:64-70)."""
    return [factors[0] / 6.0, factors[1] / 40.0,
            factors[2] / 32.0, factors[3] / 32.0]


def get_example(rng: Optional[np.random.Generator] = None):
    """(image, normalized factors) with uniform random factors
    (reference envs/dsprites.py:54-61)."""
    rng = rng or np.random.default_rng()
    factors = [int(rng.integers(6)), int(rng.integers(40)),
               int(rng.integers(32)), int(rng.integers(32))]
    return generate_image_discrete(factors), normalize_factors(factors)


def get_batch(batch_size: int = 32,
              rng: Optional[np.random.Generator] = None):
    """(x (B, 1, 64, 64), targets (B, 4)) — reference envs/dsprites.py:73-78."""
    rng = rng or np.random.default_rng()
    x = np.zeros((batch_size, 1, IMG_WIDTH, IMG_WIDTH), np.float32)
    target = np.zeros((batch_size, NUM_FACTORS), np.float32)
    for i in range(batch_size):
        img, t = get_example(rng)
        x[i, 0] = img
        target[i] = t
    return x, target


def simulator(factor_batch) -> np.ndarray:
    """(B, 4) in [0,1] -> (B, 64, 64) images, for the Higgins metric
    (reference envs/dsprites.py:82-87)."""
    return np.array([generate_image_continuous(f) for f in factor_batch])
