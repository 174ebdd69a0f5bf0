"""Unrolled-ADMM layer with learnable PSF / lambda / rho / bias.

Counterpart of torch_admm_deconv_tpu/models/admm_deconv.py (:41-100),
including the reference's "falsy => learnable" contract: ``lmbda`` / ``rho``
of None or 0 create a learnable scalar drawn from U(0, 1), any other value
is a fixed constant; a non-empty ``kern_size`` creates a learnable
(1, 1, kh, kw) PSF with xavier-uniform init; ``bias=True`` adds a learnable
scalar drawn from U(0, 1). forward = activation(admm_tv(x, ...) + b).
``gradient_mode="implicit"`` trains through the converged fixed point
instead (``ops.implicit.admm_tv_implicit``): a residual-stopped forward with
``max_iters`` as its cap, and the implicit-function-theorem gradient.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.models.layers_common import identity, xavier_uniform_conv
from torch_admm_deconv_tpu_torch.ops.implicit import admm_tv_implicit
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv
from torch_admm_deconv_tpu_torch.utils import tracing

GRADIENT_MODES = ("unroll", "implicit")


class ADMMDeconv(nn.Module):
    def __init__(self, kern_size: Tuple[int, ...] = (), max_iters: int = 100, lmbda=None,
                 rho=None, iso: bool = True, bias: bool = False,
                 activation: Callable = identity, iso_mode: str = "compat",
                 remat: bool = False, use_pallas: bool = False,
                 gradient_mode: str = "unroll", implicit_tol: float = 1e-6,
                 implicit_backward_iters: int = 50, *, device=None, generator=None):
        super().__init__()
        if gradient_mode not in GRADIENT_MODES:
            raise ValueError(f"gradient_mode must be one of {GRADIENT_MODES}, got {gradient_mode!r}")
        dev = resolve_device(device)
        self.max_iters, self.iso, self.iso_mode = max_iters, iso, iso_mode
        self.remat, self.use_pallas, self.activation = remat, use_pallas, activation
        self.gradient_mode, self.implicit_tol = gradient_mode, implicit_tol
        self.implicit_backward_iters = implicit_backward_iters

        def uniform01():
            return nn.Parameter(torch.rand(1, generator=generator).to(dev))

        # parameters are drawn in the JAX layer's order: lmbda, rho, w, b
        self.lmbda = uniform01() if not lmbda else None
        self.rho = uniform01() if not rho else None
        self.lmbda_value, self.rho_value = lmbda, rho
        self.w = (
            nn.Parameter(xavier_uniform_conv((1, 1, *kern_size), generator).to(dev))
            if kern_size else None
        )
        self.b = uniform01() if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with tracing.span("model.admm"):
            lmbd = self.lmbda.reshape(()) if self.lmbda is not None else self.lmbda_value
            rho = self.rho.reshape(()) if self.rho is not None else self.rho_value
            if self.gradient_mode == "implicit":
                out = admm_tv_implicit(
                    x, lmbd, rho, self.w, iso=self.iso, maxit=self.max_iters,
                    tol=self.implicit_tol, iso_mode=self.iso_mode,
                    backward_iters=self.implicit_backward_iters, device=x.device,
                )
            else:
                out = admm_tv(
                    x, lmbd, rho, self.w, iso=self.iso, maxit=self.max_iters,
                    iso_mode=self.iso_mode, remat=self.remat, use_pallas=self.use_pallas,
                    device=x.device,
                )
            if self.b is not None:
                out = out + self.b[0]
            return self.activation(out)
