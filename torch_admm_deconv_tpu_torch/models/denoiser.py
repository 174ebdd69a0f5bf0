"""DivergentRestorer, the flagship restoration model.

Counterpart of torch_admm_deconv_tpu/models/denoiser.py (:32-145): N levels
of ``DivergentAttention`` with ``ChannelWiseAttention`` gates between them
and the network input re-concatenated at every level; ADMM front-ends only
in level 0. Intermediate levels apply block-then-gate, the final level
gate-then-block.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.models.attention import ChannelWiseAttention
from torch_admm_deconv_tpu_torch.models.blocks import DivergentAttention, _maybe_checkpoint
from torch_admm_deconv_tpu_torch.utils import tracing

# the reference's two ADMM front-end configs (JAX denoiser.py:28-29)
DECONV1 = {"kern_size": (), "max_iters": 100, "iso": True}
DECONV2 = {"kern_size": (), "max_iters": 100, "iso": True}


class DivergentRestorer(nn.Module):
    """``remat_levels`` recomputes whole levels (and each branch's attention)
    in the backward pass. ``device``: ``None`` means CUDA; the CPU only when
    named. Weights are drawn from ``generator`` (a CPU ``torch.Generator``)."""

    def __init__(self, level_branches: Sequence[int], in_channels: int, final_channels: int,
                 filters: int, gate_channels: int, attention_reduction: int,
                 intermediate_activation: Optional[Callable] = None,
                 output_activation: Optional[Callable] = None,
                 admms: Optional[Sequence[dict]] = None, remat_levels: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        n = len(level_branches)
        self.n, self.remat_levels = n, remat_levels
        common = dict(conv_filters=filters, gate_channels=gate_channels,
                      attention_reduction=attention_reduction, remat_branches=remat_levels, **kw)
        for i in range(n):
            self.add_module(f"sca_{i}", ChannelWiseAttention(filters, **kw))
            if i == 0:
                block = DivergentAttention(level_branches[i], in_channels, filters,
                                           out_activation=intermediate_activation, admms=admms,
                                           **common)
            elif i == n - 1:
                block = DivergentAttention(level_branches[i], filters + in_channels,
                                           final_channels, out_activation=output_activation,
                                           **common)
            else:
                block = DivergentAttention(level_branches[i], filters + in_channels, filters,
                                           out_activation=intermediate_activation, **common)
            self.add_module(f"block_{i}", block)

    def _block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return _maybe_checkpoint(getattr(self, f"block_{i}"), x, self.remat_levels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n
        with tracing.span("model.level", level=0):
            out = self.sca_0(self._block(0, x))
        for i in range(1, n):
            sca = getattr(self, f"sca_{i}")
            with tracing.span("model.level", level=i):
                if i < n - 1:
                    out = sca(self._block(i, torch.cat([out, x], dim=1)))
                else:
                    out = self._block(i, torch.cat([sca(out), x], dim=1))
        return out


def flagship_divergent_restorer(
    output_activation: Callable = torch.sigmoid,
    max_iters: int = 100,
    remat: bool = True,
    use_pallas: bool = False,
    gradient_mode: str = "unroll",
    *,
    device=None,
    generator=None,
) -> DivergentRestorer:
    """The training configuration of the reference's scripts/train.py:70-73
    (JAX denoiser.py:111-145): branches [2, 8, 32], 86 filters, gate 86,
    reduction 8, and two kernel-less isotropic 100-iteration ADMM layers.

    ``use_pallas=True`` runs the ADMM layers through the whole-solve kernel:
    inference only (no backward); pair it with ``remat=False``.
    ``gradient_mode="implicit"`` trains the ADMM layers through their
    converged fixed point (``ops/implicit.py``) instead of the unroll."""
    admm = {"kern_size": (), "max_iters": max_iters, "iso": True, "remat": remat,
            "use_pallas": use_pallas, "gradient_mode": gradient_mode}
    return DivergentRestorer(
        level_branches=[2, 8, 32], in_channels=3, final_channels=3, filters=86,
        gate_channels=86, attention_reduction=8, output_activation=output_activation,
        admms=[dict(admm), dict(admm)], remat_levels=remat, device=device, generator=generator,
    )
