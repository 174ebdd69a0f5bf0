"""Post-step parameter clamps for ADMM layers, and gradient clipping.

Counterpart of torch_admm_deconv_tpu/models/regularizers.py (:20-50). Each
clamp acts in place, under ``torch.no_grad()``, on the parameters of a
module whose leaf name matches (``ADMMDeconv`` names them ``lmbda``,
``rho``, ``b`` and ``w``). The reference's ``ADMMClipper`` bug that writes
rho's values into ``bias`` is not reproduced.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn


def _clamp_named(model: nn.Module, names: Tuple[str, ...], lo: float, hi: float) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in names:
                p.clamp_(lo, hi)


def admm_weight_clipper(model: nn.Module, keep_range: Tuple[float, float]) -> None:
    """Clamp every ADMM PSF kernel ``w``."""
    _clamp_named(model, ("w",), *keep_range)


def admm_clipper(model: nn.Module, max_val: float) -> None:
    """Clamp every ``lmbda``/``rho``/``b`` to [1e-9, max_val]."""
    _clamp_named(model, ("lmbda", "rho", "b"), 1e-9, max_val)


def train_weight_clipper(model: nn.Module) -> None:
    """The training clamp: ``lmbda``/``rho`` to [1e-12, 5]."""
    _clamp_named(model, ("lmbda", "rho"), 1e-12, 5.0)


def clip_grads_by_value(parameters: Iterable[torch.Tensor], clip_value: float = 1.0) -> None:
    """Clamp every gradient to [-clip_value, clip_value] in place (NaN
    stays NaN), the reference trainer's ``clip_grad_value_(1)``."""
    torch.nn.utils.clip_grad_value_(list(parameters), clip_value)
