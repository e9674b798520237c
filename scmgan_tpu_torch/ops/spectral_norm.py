"""Spectral normalization with explicit u/v state.

Port of ``scmgan_tpu/ops/spectral_norm.py``: ``u``/``v`` live in the param
tree beside the weight, the forward pass divides by ``sigma = u . (W v)``
with u and v as constants, and the power iteration is a separate function of
the weight alone, run once per train step after the optimizer
(``update_spectral_norms``) in place of the reference's in-place update
inside every forward (spectral_normalization.py:23-35,66-68).  u and v never
carry ``requires_grad``.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _l2normalize(v: torch.Tensor) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + _EPS)


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """HWIO (or (in, out) linear) weight -> (out, rest) matrix."""
    return w.reshape(-1, w.shape[-1]).T


def sn_init(generator: torch.Generator, w: torch.Tensor,
            warmup_iters: int = 10) -> dict:
    """u/v state for weight ``w``: normal draws from ``generator``,
    normalized, then ``warmup_iters`` power iterations, so that sigma is a
    meaningful estimate from the first forward (spectral_norm.py:42)."""
    height, width = _as_matrix(w).shape

    def draw(n):
        return _l2normalize(torch.randn(n, generator=generator,
                                        device=generator.device, dtype=w.dtype))

    u = draw(height)
    v = draw(width)
    u, v = sn_power_iteration(w, u, v, iters=warmup_iters)
    return {"u": u.to(w.dtype), "v": v.to(w.dtype)}


def sn_power_iteration(w: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       iters: int = 1):
    """``iters`` power-iteration steps in f32 on the detached weight;
    returns new (u, v) in f32."""
    m = _as_matrix(w.detach()).to(torch.float32)
    u = u.to(torch.float32)
    v = v.to(torch.float32)
    for _ in range(iters):
        v = _l2normalize(m.T @ u)
        u = _l2normalize(m @ v)
    return u, v


def sn_weight(params: dict) -> torch.Tensor:
    """sigma-normalized weight, differentiable w.r.t. the raw weight only."""
    w = params["w"]
    u = params["sn"]["u"].detach().to(w.dtype)
    v = params["sn"]["v"].detach().to(w.dtype)
    sigma = torch.dot(u, _as_matrix(w) @ v)
    return w / sigma


def update_spectral_norms(params, iters: int = 1):
    """A new tree in which every ``{'w', 'sn'}`` node carries refreshed u/v
    (spectral_norm.py:83).  Other leaves are the same tensor objects; the
    u/v tensors the forward read are left as they were."""

    def walk(node):
        if isinstance(node, dict):
            if "sn" in node and "w" in node:
                u, v = sn_power_iteration(node["w"], node["sn"]["u"],
                                          node["sn"]["v"], iters)
                return {**node, "sn": {"u": u.to(node["sn"]["u"].dtype),
                                       "v": v.to(node["sn"]["v"].dtype)}}
            return {k: walk(x) for k, x in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(x) for x in node))
        return node

    return walk(params)
