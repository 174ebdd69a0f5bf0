"""Composite blocks for the restoration models.

Counterpart of torch_admm_deconv_tpu/models/blocks.py: the channel-wiring
helpers, the up / down blocks, ``MultiScaleConvPool``, ``MultiADMM`` and the
flagship ``DivergentAttention`` with its two quirks kept:

* the conv list interleaves a 1x1 conv (even index) and an ``UpDownBlock``
  (odd index) per branch; with ADMM front-ends the zip truncates it to the
  first ``branches`` entries, and without them all ``2 * branches`` convs
  run but only those whose outputs meet an attention are used
  (blocks.py:315-332). The port builds the convs that hold parameters in
  JAX, so the state dicts match, and runs only the used ones;
* the CBAM pool types alternate ('avg', 'max') / ('lp', 'lse') per branch.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from torch_admm_deconv_tpu_torch.models.admm_deconv import ADMMDeconv
from torch_admm_deconv_tpu_torch.models.attention import CBAM, AttentionChannelPooling
from torch_admm_deconv_tpu_torch.models.layers_common import (
    Conv2d,
    ConvTranspose2d,
    IntOrPair,
    _pair,
    max_pool2d,
    same_padding,
    xavier_normal_conv,
)


# channel-wiring helpers (JAX blocks.py:44-92)


def compute_residual_dec_input_channels(enc_out_channels: List[int],
                                        dec_out_channels: List[int]) -> List[int]:
    """Decoder input widths: the deepest encoder output, then each skip
    concatenated with the previous decoder output."""
    rev = enc_out_channels[::-1]
    return [rev[0]] + [e + d for e, d in zip(rev[1:], dec_out_channels[:-1])]


def compute_enc_input_channels(in_channels: int, enc_out_channels: List[int]) -> List[int]:
    return [in_channels] + enc_out_channels[:-1]


def compute_depth_enc_in_out_channels(in_channels: int,
                                      enc_out_channels: List[int]) -> Tuple[List[int], List[int]]:
    """Depthwise encoder widths: each block multiplies the width by its
    factor."""
    res = [in_channels]
    for i, k in enumerate(enc_out_channels):
        res.append(k * res[i])
    return res[:-1], res[1:]


def conv2d_pooling_output_shape(input_shape, kernel_size, stride=1, padding=0, dilation=1,
                                pooling_size=None, pooling_stride=None,
                                pooling_padding=0) -> Tuple[int, int]:
    """(H, W) after a conv and an optional pool."""
    (kh, kw), (sh, sw) = _pair(kernel_size), _pair(stride)
    (ph, pw), (dh, dw) = _pair(padding), _pair(dilation)
    h, w = input_shape
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if pooling_size is not None:
        pkh, pkw = _pair(pooling_size)
        psh, psw = _pair(pooling_stride if pooling_stride is not None else pooling_size)
        pph, ppw = _pair(pooling_padding)
        oh = (oh + 2 * pph - pkh) // psh + 1
        ow = (ow + 2 * ppw - pkw) // psw + 1
    return oh, ow


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


class DepthwiseDownBlock(nn.Module):
    """Grouped conv (``groups=in_channels``, pad pool_size-1) -> act -> pool
    (JAX blocks.py:150-177)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOrPair,
                 activation: Optional[Callable] = None, pool_size: int = 0,
                 use_bias: bool = True, *, device=None, generator=None):
        super().__init__()
        self.activation, self.pool_size = activation, pool_size
        self.depth_conv = Conv2d(in_channels, out_channels, kernel_size,
                                 padding=max(0, pool_size - 1), groups=in_channels,
                                 use_bias=use_bias, kernel_init=xavier_normal_conv,
                                 device=device, generator=generator)

    def forward(self, x):
        return _post(self.depth_conv(x), None, self.activation, self.pool_size)


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


class MultiScaleConvPool(nn.Module):
    """Reflect-padded convs at several kernel sizes in parallel, concatenated,
    then attention channel pooling down to ``out_channels``
    (JAX blocks.py:218-238)."""

    def __init__(self, in_channels: int, out_channels: int, filters: int, ks: Sequence[int],
                 *, device=None, generator=None):
        super().__init__()
        self.ks = list(ks)
        for i, k in enumerate(self.ks):
            self.add_module(f"conv_{i}", Conv2d(in_channels, filters, k, use_bias=True,
                                                device=device, generator=generator))
        self.cwa_pool = AttentionChannelPooling(filters * len(self.ks), out_channels,
                                                device=device, generator=generator)

    def forward(self, x):
        feats = [getattr(self, f"conv_{i}")(same_padding(x, k)) for i, k in enumerate(self.ks)]
        return self.cwa_pool(torch.cat(feats, dim=1))


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
