"""Composite blocks for the restoration models.

Counterpart of torch_admm_deconv_tpu/models/blocks.py, with the flagship
``DivergentAttention`` and its two quirks kept:

* the conv list interleaves a 1x1 conv (even index) and an ``UpDownBlock``
  (odd index) per branch; with ADMM front-ends the zip truncates it to the
  first ``branches`` entries, and without them all ``2 * branches`` convs
  run but only those whose outputs meet an attention are used
  (blocks.py:315-332). The port builds the convs that hold parameters in
  JAX, so the state dicts match, and runs only the used ones;
* the CBAM pool types alternate ('avg', 'max') / ('lp', 'lse') per branch.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from torch_admm_deconv_tpu_torch.models.admm_deconv import ADMMDeconv
from torch_admm_deconv_tpu_torch.models.attention import CBAM
from torch_admm_deconv_tpu_torch.models.layers_common import (
    Conv2d,
    ConvTranspose2d,
    IntOrPair,
    max_pool2d,
    xavier_normal_conv,
)


def _post(x, normalization, activation, pool_size):
    if normalization is not None:
        x = normalization(x)
    if activation is not None:
        x = activation(x)
    if pool_size:
        x = max_pool2d(x, pool_size, 1)
    return x


class DownBlock(nn.Module):
    """Conv (pad pool_size-1, no bias) -> norm -> act -> pool
    (JAX blocks.py:95-120)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOrPair,
                 activation: Optional[Callable] = None, normalization: Optional[Callable] = None,
                 pool_size: int = 0, *, device=None, generator=None):
        super().__init__()
        self.activation, self.normalization, self.pool_size = activation, normalization, pool_size
        self.down_conv = Conv2d(in_channels, out_channels, kernel_size,
                                padding=max(0, pool_size - 1), use_bias=False,
                                kernel_init=xavier_normal_conv, device=device, generator=generator)

    def forward(self, x):
        return _post(self.down_conv(x), self.normalization, self.activation, self.pool_size)


class UpBlock(nn.Module):
    """Transposed conv (no bias) -> norm -> act -> pool (JAX blocks.py:123-147)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOrPair,
                 activation: Optional[Callable] = None, normalization: Optional[Callable] = None,
                 pool_size: int = 0, *, device=None, generator=None):
        super().__init__()
        self.activation, self.normalization, self.pool_size = activation, normalization, pool_size
        self.up_conv = ConvTranspose2d(in_channels, out_channels, kernel_size, use_bias=False,
                                       kernel_init=xavier_normal_conv, device=device,
                                       generator=generator)

    def forward(self, x):
        return _post(self.up_conv(x), self.normalization, self.activation, self.pool_size)


class UpDownBlock(nn.Module):
    """Transposed conv up -> 1x1 -> conv down -> 1x1, plus a 1x1 residual
    (JAX blocks.py:180-215)."""

    def __init__(self, up_in_ch: int, up_out_ch: int, down_out_ch: int,
                 kernel_size: IntOrPair, activation: Optional[Callable] = None,
                 normalization: Optional[Callable] = None, pool_size: int = 0,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.chx = Conv2d(up_in_ch, down_out_ch, 1, use_bias=True, **kw)
        self.up_block = UpBlock(up_in_ch, up_out_ch, kernel_size, activation, normalization,
                                pool_size, **kw)
        self.chc = Conv2d(up_out_ch, up_out_ch, 1, use_bias=False, **kw)
        self.down_block = DownBlock(up_out_ch, down_out_ch, kernel_size, activation,
                                    normalization, pool_size, **kw)
        self.chc2 = Conv2d(down_out_ch, down_out_ch, 1, use_bias=False, **kw)

    def forward(self, x):
        y = self.chc2(self.down_block(self.chc(self.up_block(x))))
        return self.chx(x) + y


class MultiADMM(nn.Module):
    """Channel-concat of N ADMMDeconv layers (JAX blocks.py:241-251)."""

    def __init__(self, admm_dicts: Sequence[dict], *, device=None, generator=None):
        super().__init__()
        self.n = len(admm_dicts)
        for i, cfg in enumerate(admm_dicts):
            self.add_module(f"admm_{i}", ADMMDeconv(**cfg, device=device, generator=generator))

    def forward(self, x):
        return torch.cat([getattr(self, f"admm_{i}")(x) for i in range(self.n)], dim=1)


_POOL_TYPES = (("avg", "max"), ("lp", "lse"))


def _maybe_checkpoint(fn, x, enabled: bool):
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


class DivergentAttention(nn.Module):
    """Branches of (ADMM ->) conv -> CBAM + skip, combined as
    cat(a*b, a+b) -> 1x1 conv (JAX blocks.py:261-344). ``remat_branches``
    recomputes each branch's CBAM / UpDownBlock in the backward pass."""

    def __init__(self, branches: int, in_channels: int, out_channels: int,
                 conv_filters: int, gate_channels: int, attention_reduction: int,
                 out_activation: Optional[Callable] = None,
                 admms: Optional[Sequence[dict]] = None, remat_branches: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        if admms is not None and len(admms) != branches:
            raise ValueError("need one ADMM config per branch")
        kw = dict(device=device, generator=generator)
        self.branches, self.out_activation = branches, out_activation
        self.remat_branches = remat_branches
        half = branches // 2
        if admms is not None:
            self.used: List[int] = list(range(branches))
            built = range(branches)
        else:
            self.used = list(range(half)) + list(range(branches, branches + half))
            built = range(2 * branches)
        for i in built:
            if i % 2 == 0:
                conv = Conv2d(in_channels, conv_filters, 1, use_bias=True,
                              kernel_init=xavier_normal_conv, **kw)
            else:
                conv = UpDownBlock(in_channels, in_channels, conv_filters, 3, **kw)
            self.add_module(f"conv_{i}", conv)
        for i in range(branches):
            self.add_module(f"cbam_{i}", CBAM(gate_channels, attention_reduction,
                                              _POOL_TYPES[i % 2], use_spatial=True, **kw))
        self.n_admm = 0 if admms is None else len(admms)
        for i, cfg in enumerate(admms or ()):
            self.add_module(f"admm_{i}", ADMMDeconv(**cfg, **kw))
        self.convout = Conv2d(conv_filters * branches, out_channels, 1, use_bias=True,
                              kernel_init=xavier_normal_conv, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        remat = self.remat_branches
        if self.n_admm:
            outs = [
                _maybe_checkpoint(getattr(self, f"conv_{i}"), getattr(self, f"admm_{i}")(x),
                                  remat and i % 2 == 1)
                for i in range(self.n_admm)
            ]
        else:
            outs = [_maybe_checkpoint(getattr(self, f"conv_{i}"), x, remat and i % 2 == 1)
                    for i in self.used]
        half = self.branches // 2
        feats = []
        for i, feat in enumerate(outs):
            feats.append(_maybe_checkpoint(getattr(self, f"cbam_{i}"), feat, remat) + feat)
        outs_a = torch.cat(feats[:half], dim=1)
        outs_b = torch.cat(feats[half:], dim=1)
        y = self.convout(torch.cat([outs_a * outs_b, outs_a + outs_b], dim=1))
        return self.out_activation(y) if self.out_activation is not None else y
