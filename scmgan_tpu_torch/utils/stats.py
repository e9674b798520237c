"""Statistics helpers: ``cov``, port of ``scmgan_tpu/utils/stats.py``
(reference utils.py:3-33; imported by the reference's main.py, unused in
its main path)."""

from __future__ import annotations

import torch


def cov(m: torch.Tensor, rowvar: bool = False) -> torch.Tensor:
    """Covariance matrix of observations, 1 / (n - 1) normalized, squeezed.
    ``rowvar=False`` (the default): columns are variables, rows
    observations; a 1-D input is one variable."""
    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    if m.ndim < 2:
        m = m.reshape(1, -1)
    if not rowvar and m.shape[0] != 1:
        m = m.T
    fact = 1.0 / (m.shape[1] - 1)
    m = m - m.mean(dim=1, keepdim=True)
    return (fact * (m @ m.T)).squeeze()
