"""Proximal / shrinkage operators for the TV-ADMM z-update.

Counterpart of torch_admm_deconv_tpu/ops/prox.py. The reference's
"isotropic" ``block_thresh`` reduces its pixel norm over dims (0, 1) = batch
AND channel, so results couple across images in a batch; that default is
kept for 'compat' parity, ``axis=(1,)`` gives the per-sample norm.
"""

from __future__ import annotations

import torch

_EPS = 1e-15


def hard_thresh(x: torch.Tensor, tau) -> torch.Tensor:
    """x * 1[|x| > tau] (JAX prox.py:35-37)."""
    return x * (x.abs() > tau).to(x.dtype)


def soft_thresh(x: torch.Tensor, tau) -> torch.Tensor:
    """sign(x) * max(|x| - tau, 0) (JAX prox.py:40-42)."""
    return torch.sign(x) * torch.clamp_min(x.abs() - tau, 0.0)


def pixelnorm(x: torch.Tensor, axis=(0, 1), keepdims: bool = False) -> torch.Tensor:
    """sqrt(sum(x^2, axis) + eps); the default reduces batch and channel
    (JAX prox.py:45-48)."""
    return torch.sqrt(torch.sum(x * x, dim=tuple(axis), keepdim=keepdims) + _EPS)


def block_thresh(x: torch.Tensor, tau, axis=(0, 1)) -> torch.Tensor:
    """max(1 - tau / pixelnorm(x), 0) * x, the norm broadcast back over
    ``axis`` (JAX prox.py:51-60)."""
    norm = pixelnorm(x, axis=axis, keepdims=True)
    scale = torch.clamp_min(1.0 - tau / (norm + _EPS), 0.0)
    return scale * x


def block_thresh_joint(zx: torch.Tensor, zy: torch.Tensor, tau):
    """Isotropic TV shrinkage on the joint per-pixel magnitude of (zx, zy)
    (JAX prox.py:63-72)."""
    mag = torch.sqrt(zx * zx + zy * zy + _EPS)
    scale = torch.clamp_min(1.0 - tau / mag, 0.0)
    return scale * zx, scale * zy
