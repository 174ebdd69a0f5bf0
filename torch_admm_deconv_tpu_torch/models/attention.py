"""Channel/spatial attention: CWA, attention channel pooling, CBAM.

Counterpart of torch_admm_deconv_tpu/models/attention.py. Median and mode
are sort-based as there: the median is the lower middle element and the
mode is the most frequent value with ties broken toward the smallest, taken
from the same ascending sort (JAX attention.py:59-89, 229-244).
"""

from __future__ import annotations

import enum
from typing import Sequence, Tuple

import torch
from torch import nn

from torch_admm_deconv_tpu_torch.models.layers_common import Conv2d, InstanceNorm2d, Linear, gelu

# channel statistics (JAX attention.py:34-90): each maps (B, C, H, W) -> (B, C)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], -1)


def amean(x):
    return _flat(x).mean(dim=-1)


def astd(x):
    return _flat(x).std(dim=-1, unbiased=True)


def amax(x):
    return _flat(x).amax(dim=-1)


def amin(x):
    return _flat(x).amin(dim=-1)


def amedian(x):
    """Lower of the two middle elements, as ``torch.median``."""
    f = torch.sort(_flat(x), dim=-1).values
    return f[..., (f.shape[-1] - 1) // 2]


def mode_from_sorted(s: torch.Tensor) -> torch.Tensor:
    """Mode along the last axis of an ascending-sorted tensor: the most
    frequent value, ties toward the smallest (JAX attention.py:65-81)."""
    n = s.shape[-1]
    idx = torch.arange(n, device=s.device).expand_as(s)
    neq = torch.ones_like(s, dtype=torch.bool)
    neq[..., 1:] = s[..., 1:] != s[..., :-1]
    # index where the run containing position i starts
    run_start = torch.cummax(torch.where(neq, idx, torch.zeros_like(idx)), dim=-1).values
    run_len = idx - run_start + 1
    # argmax gives the first maximal run: the smallest of equally frequent values
    best = torch.argmax(run_len, dim=-1, keepdim=True)
    start = torch.gather(run_start, -1, best)
    return torch.gather(s, -1, start)[..., 0]


def mode_along_last(x: torch.Tensor) -> torch.Tensor:
    return mode_from_sorted(torch.sort(x, dim=-1).values)


def amodes(x):
    return mode_along_last(_flat(x))


class ChannelCompression(enum.Enum):
    """Per-channel statistics (JAX attention.py:93-104)."""

    STD = ("std", astd)
    MEAN = ("mean", amean)
    MAX = ("max", amax)
    MEDIAN = ("median", amedian)
    MODE = ("mode", amodes)
    MIN = ("min", amin)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.value[1](x)


DEFAULT_COMPRESSIONS: Tuple[ChannelCompression, ...] = (
    ChannelCompression.STD,
    ChannelCompression.MEDIAN,
    ChannelCompression.MODE,
    ChannelCompression.MAX,
    ChannelCompression.MEAN,
)


class ChannelWiseAttention(nn.Module):
    """Learnable-weighted channel statistics times a sigmoid 1x1-conv gate
    (JAX attention.py:116-151)."""

    def __init__(self, in_channels: int,
                 channel_compress_methods: Sequence[ChannelCompression] = DEFAULT_COMPRESSIONS,
                 probas_ch_factor: int = 2, reduce_probas_space: bool = False,
                 reduce_mean: bool = False, probas_only: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        c = in_channels
        probas_space = c // probas_ch_factor if reduce_probas_space else c * probas_ch_factor
        self.methods = tuple(channel_compress_methods)
        self.reduce_mean, self.probas_only = reduce_mean, probas_only
        for i in range(len(self.methods)):
            self.register_parameter(f"compress_weight_{i}", nn.Parameter(torch.ones(1, device=device)))
        self.conv1 = Conv2d(c, probas_space, 1, device=device, generator=generator)
        self.conv2 = Conv2d(probas_space, c, 1, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stats = torch.stack(
            [m(x) * getattr(self, f"compress_weight_{i}") for i, m in enumerate(self.methods)],
            dim=-1,
        )
        weighted = stats.sum(dim=-1).reshape(x.shape[0], x.shape[1], 1, 1)
        gate = torch.sigmoid(self.conv2(self.conv1(x)) * weighted)
        out = gate if self.probas_only else x * gate
        return out.mean(dim=(2, 3)) if self.reduce_mean else out


class AttentionChannelPooling(nn.Module):
    """Keep the ``select_channels`` best feature maps per sample by CWA
    probability, top-k and gather (JAX attention.py:154-181)."""

    def __init__(self, in_channels: int, select_channels: int,
                 compressions: Sequence[ChannelCompression] = (
                     ChannelCompression.STD, ChannelCompression.MEDIAN, ChannelCompression.MAX),
                 probas_channels_factor: int = 2, reduce_probas_space: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        self.select_channels = select_channels
        self.cwa = ChannelWiseAttention(
            in_channels, compressions, probas_channels_factor,
            reduce_probas_space=reduce_probas_space, reduce_mean=True, probas_only=True,
            device=device, generator=generator,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        top_idx = torch.topk(self.cwa(x), self.select_channels, dim=1).indices
        idx = top_idx[:, :, None, None].expand(-1, -1, x.shape[2], x.shape[3])
        return torch.gather(x, 1, idx)


def logsumexp_2d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 1) stable logsumexp over space
    (JAX attention.py:189-194)."""
    flat = _flat(x)
    s = flat.amax(dim=2, keepdim=True)
    return s + torch.log(torch.exp(flat - s).sum(dim=2, keepdim=True))


class BasicConv(nn.Module):
    """conv + InstanceNorm + GELU (JAX attention.py:197-226)."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, dilation: int = 1, groups: int = 1,
                 use_activation: bool = True, norm: bool = True, use_bias: bool = True,
                 *, device=None, generator=None):
        super().__init__()
        self.use_activation = use_activation
        self.conv = Conv2d(in_planes, out_planes, kernel_size, stride=stride, padding=padding,
                           dilation=dilation, groups=groups, use_bias=use_bias,
                           device=device, generator=generator)
        self.norm = InstanceNorm2d(out_planes, device=device) if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.norm is not None:
            y = self.norm(y)
        return gelu(y) if self.use_activation else y


def channel_pool(x: torch.Tensor) -> torch.Tensor:
    """Per-pixel std / median / mode across channels, median and mode from
    one sort (JAX attention.py:229-244)."""
    b, c, h, w = x.shape
    s = torch.sort(torch.movedim(x, 1, -1).reshape(-1, c), dim=-1).values
    med = s[:, (c - 1) // 2].reshape(b, h, w)
    mode = mode_from_sorted(s).reshape(b, h, w)
    std = x.std(dim=1, unbiased=True)
    return torch.stack([std, med, mode], dim=1)


class ChannelPool(nn.Module):
    """Module form of :func:`channel_pool`, no parameters
    (JAX attention.py:247-253)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channel_pool(x)


class SpatialGate(nn.Module):
    """x * sigmoid(conv(channel_pool(x))) (JAX attention.py:256-274)."""

    def __init__(self, kernel_size: int = 7, use_activation: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        self.spatial = BasicConv(3, 1, kernel_size, stride=1, padding=(kernel_size - 1) // 2,
                                 use_activation=use_activation, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.spatial(channel_pool(x)))


class ChannelGate(nn.Module):
    """Pooled-MLP channel gate with avg / max / lp / lse pool types over the
    full plane (JAX attention.py:277-318)."""

    def __init__(self, gate_channels: int, reduction_ratio: int = 16,
                 pool_types: Tuple[str, ...] = ("avg", "max"), *, device=None, generator=None):
        super().__init__()
        for p in pool_types:
            if p not in ("avg", "max", "lp", "lse"):
                raise ValueError(f"unknown pool type: {p!r}")
        self.pool_types = tuple(pool_types)
        hidden = gate_channels // reduction_ratio
        self.fc1 = Linear(gate_channels, hidden, device=device, generator=generator)
        self.fc2 = Linear(hidden, gate_channels, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        att_sum = None
        for pool_type in self.pool_types:
            if pool_type == "avg":
                pooled = x.mean(dim=(2, 3), keepdim=True)
            elif pool_type == "max":
                pooled = x.amax(dim=(2, 3), keepdim=True)
            elif pool_type == "lp":
                pooled = torch.sqrt((x ** 2).sum(dim=(2, 3), keepdim=True))
            else:
                pooled = logsumexp_2d(x)
            att = self.fc2(gelu(self.fc1(pooled.reshape(pooled.shape[0], -1))))
            att_sum = att if att_sum is None else att_sum + att
        return x * torch.sigmoid(att_sum)[:, :, None, None]


class CBAM(nn.Module):
    """Channel gate, then an optional spatial gate (JAX attention.py:321-336)."""

    def __init__(self, gate_channels: int, reduction_ratio: int = 16,
                 pool_types: Tuple[str, ...] = ("avg", "max"), use_spatial: bool = False,
                 *, device=None, generator=None):
        super().__init__()
        self.channel_gate = ChannelGate(gate_channels, reduction_ratio, pool_types,
                                        device=device, generator=generator)
        self.spatial_gate = SpatialGate(device=device, generator=generator) if use_spatial else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.channel_gate(x)
        return self.spatial_gate(y) if self.spatial_gate is not None else y
