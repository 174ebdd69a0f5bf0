"""Plain fixed-iteration TV-ADMM deconvolution, the yardstick of the
classical cells.

Written from the update equations alone and importing nothing of the
program under test. Scaled-form ADMM for

    min_x  1/2 ||H x - y||^2 + lambda ||D x||_1     (D = circular Dx, Dy)

with s = H^T y and u = 0 at the start, then ``maxit`` times

    x  = (H^T H + rho D^T D)^-1 s          (diagonal in the Fourier domain)
    z  = shrink(D x + u, lambda / rho)     (soft per pixel, or iso per pixel
                                            over the channels)
    u  = u + D x - z
    s  = H^T y + rho D^T (z - u)

and the last x is the answer. The PSF is centred at ((kh-1)//2, (kw-1)//2)
in H^T, circular boundaries throughout.

``solve`` runs the x-update on ``torch.fft`` in the dtype it is given
(float64 for the reference). ``solve_tf32`` is the same iteration with the
x-update as the separable cas transform T_h v T_w computed as matrix
products whose operands are rounded to TF32 (10 explicit mantissa bits)
with float32 accumulation, everything else in float32: the control, one
precision below the float32 the configuration states.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-15


def gaussian_psf(size: int, sigma: float, dtype=torch.float64) -> torch.Tensor:
    """(1, 1, size, size) normalised Gaussian."""
    ax = torch.arange(size, dtype=torch.float64) - (size - 1) / 2.0
    g = torch.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    k = torch.outer(g, g)
    return (k / k.sum()).reshape(1, 1, size, size).to(dtype)


def psf_from_config(psf: dict, dtype=torch.float64) -> torch.Tensor:
    if psf["kind"] != "gaussian":
        raise ValueError(f"unknown PSF kind {psf['kind']!r}")
    return gaussian_psf(int(psf["size"]), float(psf["sigma"]), dtype)


def _centred(kern: torch.Tensor, h: int, w: int) -> torch.Tensor:
    kh, kw = kern.shape[-2:]
    pad = torch.zeros((h, w), dtype=kern.dtype, device=kern.device)
    pad[:kh, :kw] = kern.reshape(kh, kw)
    return torch.roll(pad, (-((kh - 1) // 2), -((kw - 1) // 2)), dims=(0, 1))


def _d2(h: int, w: int, dtype, device) -> torch.Tensor:
    """|Dx_hat|^2 + |Dy_hat|^2 on the full (h, w) grid."""
    wy = 2.0 * math.pi * torch.arange(h, dtype=dtype, device=device) / h
    wx = 2.0 * math.pi * torch.arange(w, dtype=dtype, device=device) / w
    return (4.0 * torch.sin(wy / 2) ** 2)[:, None] + (4.0 * torch.sin(wx / 2) ** 2)[None, :]


def dx(x):
    return x - torch.roll(x, 1, dims=-1)


def dy(x):
    return x - torch.roll(x, 1, dims=-2)


def dx_t(a):
    return a - torch.roll(a, -1, dims=-1)


def dy_t(a):
    return a - torch.roll(a, -1, dims=-2)


def shrink(v, tau, iso: bool):
    """Soft threshold per pixel, or (iso) the block threshold with the norm
    over batch and channels, which is per sample at batch 1."""
    if not iso:
        return torch.sign(v) * torch.clamp_min(v.abs() - tau, 0.0)
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True) + EPS)
    return torch.clamp_min(1.0 - tau / (norm + EPS), 0.0) * v


def _iterate(y, hty, x_update, lmbd, rho, maxit: int, iso: bool):
    tau = lmbd / rho
    s = hty
    ux = torch.zeros_like(y)
    uy = torch.zeros_like(y)
    x = torch.zeros_like(y)
    for _ in range(maxit):
        x = x_update(s)
        gx, gy = dx(x), dy(x)
        zx, zy = shrink(gx + ux, tau, iso), shrink(gy + uy, tau, iso)
        ux = ux + gx - zx
        uy = uy + gy - zy
        s = hty + rho * (dx_t(zx - ux) + dy_t(zy - uy))
    return x


def solve(y: torch.Tensor, lmbd: float, rho: float, kern, maxit: int, iso: bool) -> torch.Tensor:
    """The reference solve of a (B, C, H, W) batch in ``y``'s dtype and on
    its device; ``kern`` a (1, 1, kh, kw) PSF or None."""
    h, w = y.shape[-2:]
    d2 = _d2(h, w, y.dtype, y.device)[:, : w // 2 + 1]
    if kern is None:
        otf = None
        h2 = torch.ones((), dtype=y.dtype, device=y.device)
        hty = y
    else:
        otf = torch.fft.rfft2(_centred(kern.to(y.device, y.dtype), h, w))
        h2 = otf.real ** 2 + otf.imag ** 2
        hty = torch.fft.irfft2(torch.conj(otf) * torch.fft.rfft2(y), s=(h, w))
    freq = 1.0 / (h2 + rho * d2)

    def x_update(s):
        return torch.fft.irfft2(freq * torch.fft.rfft2(s), s=(h, w))

    return _iterate(y, hty, x_update, lmbd, rho, maxit, iso)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _cas(n: int, device) -> torch.Tensor:
    k = torch.arange(n, dtype=torch.float64)
    ang = 2.0 * math.pi * torch.outer(k, k) / n
    return (torch.cos(ang) + torch.sin(ang)).to(torch.float32).to(device)


def solve_tf32(y: torch.Tensor, lmbd: float, rho: float, kern, maxit: int,
               iso: bool) -> torch.Tensor:
    """The control: :func:`solve` in float32 with the x-update as TF32
    products of the cas transform (valid for a PSF even in both axes, as
    the configurations' Gaussians are)."""
    y = y.to(torch.float32)
    h, w = y.shape[-2:]
    d2 = _d2(h, w, torch.float64, y.device)
    if kern is None:
        h2 = torch.ones((), dtype=torch.float64, device=y.device)
        hty = y
    else:
        k = kern.to(y.device, torch.float64)
        otf = torch.fft.fft2(_centred(k, h, w))
        h2 = otf.real ** 2 + otf.imag ** 2
        hty = torch.fft.irfft2(torch.conj(otf[:, : w // 2 + 1]).to(torch.complex64)
                               * torch.fft.rfft2(y), s=(h, w))
    # the inverse transform's 1 / (h w) folded into the spectrum
    freq = (1.0 / (h2 + rho * d2) / (h * w)).to(torch.float32)
    th, tw = tf32(_cas(h, y.device)), tf32(_cas(w, y.device))

    def cas2(v):
        return th @ tf32(tf32(v) @ tw)

    def x_update(s):
        return cas2(cas2(s) * freq)

    return _iterate(y, hty, x_update, float(lmbd), float(rho), maxit, iso)
