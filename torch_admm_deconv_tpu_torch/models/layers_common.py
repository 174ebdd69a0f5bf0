"""NCHW building-block layers with torch-style semantics.

Counterpart of torch_admm_deconv_tpu/models/layers_common.py. Parameters
keep the JAX package's initializers (xavier for the model's convs,
kaiming-uniform as the torch default) and are drawn from an explicit
``torch.Generator`` on the CPU, then moved to the module's device. Layouts:
conv weights are OIHW, a transposed conv's weight is (in, out, kh, kw) as
torch wants it, a linear weight is (out, in).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

IntOrPair = Union[int, Tuple[int, int]]


def _pair(v: IntOrPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def xavier_uniform_conv(shape, generator=None) -> torch.Tensor:
    """Xavier uniform for OIHW kernels (JAX layers_common.py:26-32)."""
    o, i, kh, kw = shape
    a = math.sqrt(6.0 / (i * kh * kw + o * kh * kw))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * a


def xavier_normal_conv(shape, generator=None) -> torch.Tensor:
    """Xavier normal for OIHW kernels (JAX layers_common.py:35-40)."""
    o, i, kh, kw = shape
    std = math.sqrt(2.0 / (i * kh * kw + o * kh * kw))
    return std * torch.randn(shape, generator=generator)


def kaiming_uniform_conv(shape, generator=None) -> torch.Tensor:
    """torch's Conv2d default, kaiming uniform with a=sqrt(5)
    (JAX layers_common.py:49-54)."""
    o, i, kh, kw = shape
    bound = math.sqrt(6.0 / ((1 + 5.0) * i * kh * kw))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def _param(value: torch.Tensor, device) -> nn.Parameter:
    return nn.Parameter(value.to(device=device, dtype=torch.float32))


class Conv2d(nn.Module):
    """torch-semantics 2-D conv on NCHW input, OIHW weight, zero padding
    (JAX layers_common.py:57-98; its reflect / circular ``pad_mode`` is
    unused by the ported models and not ported)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOrPair,
                 stride: IntOrPair = 1, padding: IntOrPair = 0, dilation: IntOrPair = 1,
                 groups: int = 1, use_bias: bool = True,
                 kernel_init: Callable = kaiming_uniform_conv,
                 *, device=None, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        self.dilation, self.groups = _pair(dilation), groups
        self.weight = _param(kernel_init((out_channels, in_channels // groups, kh, kw), generator), device)
        self.bias = _param(torch.zeros(out_channels), device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding, self.dilation,
                        self.groups)


class ConvTranspose2d(nn.Module):
    """torch-semantics transposed conv (JAX layers_common.py:101-135). The
    JAX module stores (out, in, kh, kw) and flips at apply time; this one
    stores torch's (in, out, kh, kw), which is the same numbers transposed
    in the first two axes."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: IntOrPair,
                 stride: IntOrPair = 1, padding: IntOrPair = 0, use_bias: bool = True,
                 kernel_init: Callable = kaiming_uniform_conv, *, device=None, generator=None):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride, self.padding = _pair(stride), _pair(padding)
        # drawn in the JAX layout so the initializer sees the same fans
        w = kernel_init((out_channels, in_channels, kh, kw), generator)
        self.weight = _param(w.transpose(0, 1).contiguous(), device)
        self.bias = _param(torch.zeros(out_channels), device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride, self.padding)


class Linear(nn.Module):
    """y = x W^T + b, weight (out, in) (JAX layers_common.py:138-155, which
    stores (in, out))."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 *, device=None, generator=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)

        def init(shape):
            return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound

        self.weight = _param(init((in_features, out_features)).t().contiguous(), device)
        self.bias = _param(init((out_features,)), device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class InstanceNorm2d(nn.Module):
    """Per-sample, per-channel spatial normalization, affine
    (JAX layers_common.py:158-175)."""

    def __init__(self, num_features: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param(torch.ones(num_features), device)
        self.bias = _param(torch.zeros(num_features), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=(-2, -1), keepdim=True)
        var = x.var(dim=(-2, -1), unbiased=False, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps)
        return y * self.weight[None, :, None, None] + self.bias[None, :, None, None]


def same_padding(x: torch.Tensor, kernel_size: IntOrPair) -> torch.Tensor:
    """Reflect-pad so a valid conv keeps spatial dims
    (JAX layers_common.py:196-201)."""
    kh, kw = _pair(kernel_size)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    return F.pad(x, (pw, pw, ph, ph), mode="reflect")


def max_pool2d(x: torch.Tensor, kernel: IntOrPair, stride: Optional[IntOrPair] = None) -> torch.Tensor:
    """Valid max pooling (JAX layers_common.py:204-214)."""
    return F.max_pool2d(x, _pair(kernel), _pair(stride if stride is not None else kernel))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU (JAX layers_common.py:295-296)."""
    return F.gelu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x
