"""Periodic finite-difference and blur operators for TV-ADMM.

Counterpart of torch_admm_deconv_tpu/ops/fdops.py. The circulant difference
operators are one-pixel circular shifts:
  Dx  x = x - roll(x, +1, -1)      Dx^T a = a - roll(a, -1, -1)
  Dy  x = x - roll(x, +1, -2)      Dy^T a = a - roll(a, -1, -2)
and the blur's transfer functions are ``torch.fft`` transforms of the
zero-padded PSF.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import torch
import torch.nn.functional as F


def dx(x: torch.Tensor) -> torch.Tensor:
    """Backward difference along W, circular (JAX fdops.py:33-35)."""
    return x - torch.roll(x, 1, dims=-1)


def dy(x: torch.Tensor) -> torch.Tensor:
    """Backward difference along H, circular (JAX fdops.py:38-40)."""
    return x - torch.roll(x, 1, dims=-2)


def dx_t(a: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`dx` (JAX fdops.py:43-45)."""
    return a - torch.roll(a, -1, dims=-1)


def dy_t(a: torch.Tensor) -> torch.Tensor:
    """Adjoint of :func:`dy` (JAX fdops.py:48-50)."""
    return a - torch.roll(a, -1, dims=-2)


def conv_circular(x: torch.Tensor, w: torch.Tensor,
                  pads: Tuple[int, int, int, int]) -> torch.Tensor:
    """Depthwise circular cross-correlation: NCHW input, (O, 1, kh, kw)
    kernel (one kernel shared by every channel when O is 1), ``pads`` as
    (left, right, top, bottom) (JAX fdops.py:53-77)."""
    left, right, top, bottom = pads
    xp = F.pad(x, (left, right, top, bottom), mode="circular")
    c = x.shape[1]
    w = w.to(x.dtype)
    if w.shape[0] == 1:
        w = w.expand(c, 1, *w.shape[-2:])
    return F.conv2d(xp, w, groups=c)


def _pad_to(kern: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    h, w = shape
    return F.pad(kern, (0, w - kern.shape[-1], 0, h - kern.shape[-2]))


def psf_otf(kern: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """rfft2 of the PSF zero-padded top-left to ``shape``; trailing dims
    (H, W//2+1) (JAX fdops.py:80-93)."""
    return torch.fft.rfft2(_pad_to(kern, shape))


def grad_otf_abs2(shape: Tuple[int, int], dtype=torch.float32, device=None) -> torch.Tensor:
    """|Dx_hat|^2 + |Dy_hat|^2 = 4 sin^2(w/2) summed over axes, on the rfft2
    grid, (H, W//2+1) (JAX fdops.py:96-110)."""
    h, w = shape
    wy = 2.0 * math.pi * torch.arange(h, dtype=dtype, device=device) / h
    wx = 2.0 * math.pi * torch.arange(w // 2 + 1, dtype=dtype, device=device) / w
    sy2 = 4.0 * torch.sin(wy / 2.0) ** 2
    sx2 = 4.0 * torch.sin(wx / 2.0) ** 2
    return sy2[:, None] + sx2[None, :]


def _empty(kern) -> bool:
    return kern is None or kern.numel() == 0


def freq_denominator(shape: Tuple[int, int], rho, kern, dtype=torch.float32, device=None) -> torch.Tensor:
    """1 / (|H_hat|^2 + rho * |D_hat|^2); |H_hat|^2 = 1 without a PSF.
    Returns (H, W//2+1) real (JAX fdops.py:113-130)."""
    d2 = grad_otf_abs2(shape, dtype, device)
    if _empty(kern):
        h_abs2 = torch.ones((), dtype=dtype, device=device)
    else:
        otf = psf_otf(kern.to(dtype), shape)
        h_abs2 = (otf.real * otf.real + otf.imag * otf.imag).reshape(shape[0], shape[1] // 2 + 1)
    return 1.0 / (h_abs2 + rho * d2)


def psf_otf_centered(kern: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    """OTF of the PSF centered at (floor((kh-1)/2), floor((kw-1)/2)), the
    reference's half-pad convention (JAX fdops.py:148-171)."""
    kh, kw = kern.shape[-2], kern.shape[-1]
    top, left = (kh - 1) // 2, (kw - 1) // 2
    centered = torch.roll(_pad_to(kern, shape), (-top, -left), dims=(-2, -1))
    return torch.fft.rfft2(centered)


def htran_fft(x: torch.Tensor, otf_c: torch.Tensor, im_shape: Tuple[int, int]) -> torch.Tensor:
    """H^T x = irfft2(conj(OTF) * rfft2(x)) (JAX fdops.py:174-178)."""
    return torch.fft.irfft2(torch.conj(otf_c) * torch.fft.rfft2(x), s=im_shape)


def _htran_pads(kh: int, kw: int) -> Tuple[int, int, int, int]:
    """(left, right, top, bottom) circular pads of the H^T correlation: the
    kernel centred at (floor((kh-1)/2), floor((kw-1)/2)) (JAX
    fdops.py:133-145)."""
    top, bottom = (kh - 1) // 2, kh - 1 - (kh - 1) // 2
    left, right = (kw - 1) // 2, kw - 1 - (kw - 1) // 2
    return (left, right, top, bottom)


def htran_operator(kern):
    """H^T as a callable on NCHW batches: the identity without a PSF, else
    the depthwise circular correlation with the flipped PSF (JAX
    fdops.py:181-193). The solver computes H^T by FFT (:func:`htran_fft`);
    this is its spatial-domain form."""
    if _empty(kern):
        return lambda x: x
    kh, kw = int(kern.shape[-2]), int(kern.shape[-1])
    flipped = torch.flip(kern.reshape(1, 1, kh, kw), dims=(-2, -1))
    return partial(conv_circular, w=flipped, pads=_htran_pads(kh, kw))
