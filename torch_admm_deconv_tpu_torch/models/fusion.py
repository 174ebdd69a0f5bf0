"""ADMM fusion layers: parallel deconvolutions and attention channel
selection.

Counterpart of torch_admm_deconv_tpu/models/fusion.py. Each ``ADMMDeconv``
takes its config dict as it is, ``use_pallas`` included, so a layer at batch
1 with ``use_pallas`` runs on the whole-solve kernel (K2) on the GPU.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.models.admm_deconv import ADMMDeconv
from torch_admm_deconv_tpu_torch.models.attention import (
    AttentionChannelPooling,
    ChannelCompression,
)


class Deconvs(nn.Module):
    """Channel concatenation of N ``ADMMDeconv`` layers ``block_{i}``
    (JAX fusion.py:20-30)."""

    def __init__(self, admms_args: Sequence[dict], *, device=None, generator=None):
        super().__init__()
        self.n = len(admms_args)
        device = resolve_device(device)
        for i, cfg in enumerate(admms_args):
            self.add_module(f"block_{i}", ADMMDeconv(**cfg, device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([getattr(self, f"block_{i}")(x) for i in range(self.n)], dim=1)


class ADMMFusion(nn.Module):
    """N differently configured ``ADMMDeconv`` layers ``admm_{i}``,
    concatenated, then ``in_channels`` of their channels chosen per sample
    by attention channel pooling (``acp``); ``with_admms`` appends the
    concatenation itself (JAX fusion.py:33-67)."""

    def __init__(self, admms_cfgs: Sequence[dict], in_channels: int,
                 compressions: Sequence[ChannelCompression] = (
                     ChannelCompression.STD, ChannelCompression.MEDIAN,
                     ChannelCompression.MAX, ChannelCompression.MEAN),
                 probas_channels_factor: int = 2, reduce_probas_space: bool = False,
                 with_admms: bool = False, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.n, self.with_admms = len(admms_cfgs), with_admms
        for i, cfg in enumerate(admms_cfgs):
            self.add_module(f"admm_{i}", ADMMDeconv(**cfg, **kw))
        self.acp = AttentionChannelPooling(in_channels * self.n, in_channels, compressions,
                                           probas_channels_factor, reduce_probas_space, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = torch.cat([getattr(self, f"admm_{i}")(x) for i in range(self.n)], dim=1)
        selected = self.acp(fused)
        return torch.cat([selected, fused], dim=1) if self.with_admms else selected
