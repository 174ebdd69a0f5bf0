"""RestorerV2: multi-scale conv pooling blocks with LayerNorm and an
optional MultiADMM front end.

Counterpart of torch_admm_deconv_tpu/models/denoiser_v2.py (a working
completion of the reference's stub). GELU is the tanh approximation,
``jax.nn.gelu``'s default.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.models.blocks import MultiADMM, MultiScaleConvPool
from torch_admm_deconv_tpu_torch.models.layers_common import Conv2d, LayerNorm2d


class RestorerV2Block(nn.Module):
    """[x | MultiADMM(x)] -> LayerNorm2d (eps 1e-9) -> MultiScaleConvPool,
    plus a 1x1 projection of the block's input, then GELU
    (JAX denoiser_v2.py:23-40). Each ADMM layer keeps the input's
    ``in_c`` channels, so the normalised width is ``in_c`` times one more
    than the number of ADMM layers."""

    def __init__(self, in_c: int, filters: int, out_c: int, ks: Sequence[int] = (3, 5, 7),
                 admms_dicts: Optional[Sequence[dict]] = None, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.admms = MultiADMM(admms_dicts, **kw) if admms_dicts else None
        c_in = in_c * (1 + len(admms_dicts or ()))
        self.norm = LayerNorm2d(c_in, eps=1e-9, device=device)
        self.msconv1 = MultiScaleConvPool(c_in, out_c, filters, list(ks), **kw)
        self.res_proj = Conv2d(c_in, out_c, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.admms is not None:
            x = torch.cat([x, self.admms(x)], dim=1)
        h = self.msconv1(self.norm(x))
        return F.gelu(h + self.res_proj(x), approximate="tanh")


class RestorerV2(nn.Module):
    """Blocks ``block_{i}`` of ``blocks_filters`` widths (the first with the
    ADMM front end), a 1x1 ``head`` back to ``in_channels``, sigmoid
    (JAX denoiser_v2.py:43-64). ``blocks_gate_channels`` and
    ``blocks_attention_reduction`` are kept for the signature and unused, as
    in JAX."""

    def __init__(self, in_channels: int, blocks_filters: Sequence[int],
                 blocks_gate_channels: Sequence[int], blocks_attention_reduction: Sequence[int],
                 admms: Optional[Sequence[dict]] = None, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.n = len(blocks_filters)
        c = in_channels
        for i, filters in enumerate(blocks_filters):
            self.add_module(f"block_{i}", RestorerV2Block(
                in_c=c, filters=filters, out_c=filters, admms_dicts=admms if i == 0 else None,
                **kw))
            c = filters
        self.head = Conv2d(c, in_channels, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x)
        return torch.sigmoid(self.head(x))
