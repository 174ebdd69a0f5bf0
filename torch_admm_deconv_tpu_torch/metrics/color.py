"""sRGB -> CIELAB conversion.

Counterpart of torch_admm_deconv_tpu/metrics/color.py (:14-57): input RGB
in [0, 1], D65 white point, L in [0, 100], a/b roughly [-100, 100]. The
3x3 colour matrix is applied as float32 multiply-adds, never as a matmul
that TF32 could round.
"""

from __future__ import annotations

import torch

# sRGB -> XYZ (D65) matrix
_RGB2XYZ = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)
_WHITE = (0.950456, 1.0, 1.088754)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` with its gradient: min(max(x, lo), hi), whose ties split
    the gradient 0.5 / 0.5 where ``torch.clamp`` passes all of it."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def _srgb_linearize(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) RGB in [0, 1] -> (B, 3, H, W) Lab."""
    lin = _srgb_linearize(clip(rgb, 0.0, 1.0))
    xyz = torch.stack(
        [(m[0] * lin[:, 0] + m[1] * lin[:, 1] + m[2] * lin[:, 2]) / white
         for m, white in zip(_RGB2XYZ, _WHITE)],
        dim=1,
    )
    eps = 0.008856
    kappa = 7.787
    # double-where keeps the cube root's gradient finite on the linear branch
    above = xyz > eps
    safe = torch.where(above, xyz, torch.ones_like(xyz))
    f = torch.where(above, safe.pow(1.0 / 3.0), kappa * xyz + 16.0 / 116.0)
    fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
    lum = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([lum, a, b], dim=1)


def rgb_to_grayscale(rgb: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma, matching torchvision rgb_to_grayscale."""
    return (0.2989 * rgb[:, 0] + 0.587 * rgb[:, 1] + 0.114 * rgb[:, 2])[:, None]
