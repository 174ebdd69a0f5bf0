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
from typing import Callable, Optional, Sequence, Tuple, Union

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


#: the reference's ``default_init_weights`` (xavier normal over conv kernels),
#: an initializer here as in JAX (layers_common.py:43-46)
default_init_weights = xavier_normal_conv


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


class LayerNorm2d(nn.Module):
    """Channel LayerNorm on NCHW: each pixel normalised over its C values,
    eps 1e-6, then a per-channel affine (JAX layers_common.py:178-193). The
    statistics are plain reductions in the input's dtype (float32 in the
    models), no matmul or convolution that TF32 could touch."""

    def __init__(self, channels: int, eps: float = 1e-6, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _param(torch.ones(channels), device)
        self.bias = _param(torch.zeros(channels), device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=1, keepdim=True)
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


def avg_pool2d(x: torch.Tensor, kernel: IntOrPair,
               stride: Optional[IntOrPair] = None) -> torch.Tensor:
    """Valid average pooling (JAX layers_common.py:217-228)."""
    return F.avg_pool2d(x, _pair(kernel), _pair(stride if stride is not None else kernel))


def adaptive_avg_pool2d_1(x: torch.Tensor) -> torch.Tensor:
    """Global average pool to (B, C, 1, 1) (JAX layers_common.py:231-233)."""
    return x.mean(dim=(-2, -1), keepdim=True)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C r^2, H, W) -> (B, C, H r, W r), torch's PixelShuffle order
    (JAX layers_common.py:236-242)."""
    return F.pixel_shuffle(x, r)


def _cubic_resize_matrix(n_in: int, scale: int) -> torch.Tensor:
    """(n_in * scale, n_in) weights of ``jax.image.resize(method="cubic")``
    along one axis (jax/_src/image/scale.py ``compute_weight_mat``): Keys'
    cubic with a = -0.5 at half-pixel centres, each output's weights divided
    by their sum (which renormalises them at the borders). Built in float64
    and rounded once."""
    n_out = n_in * scale
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) / scale - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float64)[None, :]).abs()
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    return w / w.sum(dim=1, keepdim=True)


def interpolate_bicubic(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bicubic upsample of NCHW by an integer factor, as the JAX package's
    ``jax.image.resize(..., method="cubic")`` (JAX layers_common.py:245-249).
    Not ``F.interpolate(mode="bicubic")``, whose kernel has a = -0.75 and
    which clamps indices at the borders instead of renormalising."""
    h, w = x.shape[-2:]
    rows = _cubic_resize_matrix(h, scale).to(device=x.device, dtype=x.dtype)
    cols = _cubic_resize_matrix(w, scale).to(device=x.device, dtype=x.dtype)
    return rows @ x @ cols.t()


def unfold(x: torch.Tensor, kernel: IntOrPair, stride: IntOrPair) -> torch.Tensor:
    """NCHW -> (B, C*kh*kw, L) valid patches, channel-major
    (JAX layers_common.py:252-266)."""
    return F.unfold(x, _pair(kernel), stride=_pair(stride))


def fold(patches: torch.Tensor, output_size: Tuple[int, int], kernel: IntOrPair,
         stride: IntOrPair) -> torch.Tensor:
    """(B, C*kh*kw, L) -> NCHW with overlap-add (JAX layers_common.py:269-283)."""
    return F.fold(patches, tuple(output_size), _pair(kernel), stride=_pair(stride))


class Sequential(nn.Module):
    """Apply ``layers`` in turn; modules among them are registered as
    ``layers_{i}``, Flax's names for a list attribute's entries
    (JAX layers_common.py:286-292)."""

    def __init__(self, layers: Sequence[Callable]):
        super().__init__()
        self.layers = list(layers)
        for i, layer in enumerate(self.layers):
            if isinstance(layer, nn.Module):
                self.add_module(f"layers_{i}", layer)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU (JAX layers_common.py:295-296)."""
    return F.gelu(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(x)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x
