"""Unrolled ADMM with a learned proximal z-update (plug-and-play style).

Counterpart of torch_admm_deconv_tpu/models/learned_prox.py (BASELINE.json
config 4): the TV shrinkage of the z-update becomes a small residual CNN on
the joint (d + u) gradient pair whose output conv starts at zero, so a fresh
model is exactly the classical anisotropic solve; the x-update stays the
circulant frequency solve, the prox weights are shared across the unrolled
stages, and lambda and rho are learnable (1,) parameters named ``lmbda`` and
``rho``, which the trainer's clamp finds by name. GELU is the tanh
approximation, ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.models.layers_common import Conv2d, _param, xavier_uniform_conv
from torch_admm_deconv_tpu_torch.ops import fdops
from torch_admm_deconv_tpu_torch.ops.prox import soft_thresh
from torch_admm_deconv_tpu_torch.ops.solver import _htran, _x_update


def _zeros(shape, generator=None) -> torch.Tensor:
    return torch.zeros(shape)


class ProxNet(nn.Module):
    """Residual CNN prox on the (B, 2C, H, W) gradient pair: soft threshold
    as the base point, plus a correction from [v | base] through
    ``conv_in``, ``depth - 2`` hidden convs ``conv_{i}`` and ``conv_out``,
    which starts at zero (JAX learned_prox.py:28-54)."""

    def __init__(self, channels: int, hidden: int = 32, depth: int = 3, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        c2 = 2 * channels
        self.depth = depth
        self.conv_in = Conv2d(2 * c2, hidden, 3, padding=1, **kw)
        for i in range(depth - 2):
            self.add_module(f"conv_{i}", Conv2d(hidden, hidden, 3, padding=1, **kw))
        self.conv_out = Conv2d(hidden, c2, 3, padding=1, kernel_init=_zeros, **kw)

    def forward(self, v: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        base = soft_thresh(v, tau)
        h = F.gelu(self.conv_in(torch.cat([v, base], dim=1)), approximate="tanh")
        for i in range(self.depth - 2):
            h = F.gelu(getattr(self, f"conv_{i}")(h), approximate="tanh")
        return base + self.conv_out(h)


class LearnedProxADMM(nn.Module):
    """``steps`` unrolled ADMM stages sharing one ``ProxNet`` (``prox``)
    (JAX learned_prox.py:57-116). ``kern_size`` empty: denoising (H = I).
    With ``psf_fixed`` (the PSF's ``prod(kern_size)`` values, flattened) H
    is that fixed operator, held in a buffer outside the state dict, and
    there is no ``w``; otherwise a non-empty ``kern_size`` makes a
    learnable Xavier-uniform PSF ``w`` of (1, 1, *kern_size), as in
    ``ADMMDeconv``. ``remat`` recomputes each prox call in the backward pass
    (``torch.utils.checkpoint``). ``device``: ``None`` means CUDA; the CPU
    only when named."""

    def __init__(self, steps: int = 10, channels: int = 3, kern_size: Tuple[int, ...] = (),
                 hidden: int = 32, remat: bool = True,
                 psf_fixed: Optional[Tuple[float, ...]] = None, *, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.steps, self.channels, self.remat = steps, channels, remat
        self.lmbda = _param(torch.full((1,), 0.05), dev)
        self.rho = _param(torch.full((1,), 1.0), dev)
        self.w = None
        if psf_fixed is not None:
            if not kern_size:
                raise ValueError("psf_fixed requires kern_size")
            psf = torch.tensor(psf_fixed, dtype=torch.float32).reshape(1, 1, *kern_size)
            self.register_buffer("psf", psf.to(dev), persistent=False)
        else:
            self.psf = None
            if kern_size:
                self.w = _param(xavier_uniform_conv((1, 1, *kern_size), generator), dev)
        self.prox = ProxNet(channels, hidden, device=dev, generator=generator)

    def forward(self, xin: torch.Tensor) -> torch.Tensor:
        dtype, im_shape, c = xin.dtype, tuple(xin.shape[-2:]), self.channels
        lmbd = self.lmbda.abs().reshape(()) + 1e-8
        rho = self.rho.abs().reshape(()) + 1e-8
        tau = lmbd / rho
        kern = self.psf if self.psf is not None else self.w
        freq_c = fdops.freq_denominator(im_shape, rho, kern, dtype, xin.device)
        hty = _htran(xin, kern, im_shape, dtype)
        s, u = hty, torch.zeros_like(torch.cat([xin, xin], dim=1))
        x = torch.zeros_like(xin)
        for _ in range(self.steps):
            x = _x_update(s, freq_c, im_shape)
            d = torch.cat([fdops.dx(x), fdops.dy(x)], dim=1)
            if self.remat and torch.is_grad_enabled():
                z = checkpoint(self.prox, d + u, tau, use_reentrant=False)
            else:
                z = self.prox(d + u, tau)
            u = u + d - z
            t = z - u
            s = hty + rho * (fdops.dx_t(t[:, :c]) + fdops.dy_t(t[:, c:]))
        return x


def default_learned_prox(kern: int = 0, steps: int = 10, hidden: int = 32, psf=None, *,
                         device=None, generator=None) -> LearnedProxADMM:
    """The one construction shared by the train and eval scripts (JAX
    learned_prox.py:119-143), so their state dicts match: 3 channels;
    ``kern`` 0 is denoising, N a (1, 1, N, N) PSF, fixed to ``psf`` when
    given (non-blind), learnable Xavier-uniform otherwise."""
    kern_size = (kern, kern) if kern else ()
    psf_fixed = None
    if psf is not None:
        if not kern:
            raise ValueError("psf requires kern > 0")
        psf_fixed = tuple(float(v) for v in np.asarray(psf).reshape(-1))
        if len(psf_fixed) != kern * kern:
            raise ValueError(f"psf has {len(psf_fixed)} values, kern {kern} needs {kern * kern}")
    return LearnedProxADMM(steps=steps, channels=3, kern_size=kern_size, hidden=hidden,
                           psf_fixed=psf_fixed, device=device, generator=generator)
