"""Patch-local attention: each spatial patch through its own gate.

Counterpart of torch_admm_deconv_tpu/models/local_patch.py: unfold the
image into patches, a learnable residual gate per patch
(``PatchProcessor``), fold back with overlap-add. The JAX modules infer the
gate's ``Linear`` width and the channel count from the first input; a torch
module needs them at construction, so ``PatchProcessor`` takes
``patch_size`` and ``LocalAttentionPatch`` takes ``channels`` (optional in
JAX). The validation errors are the JAX module's; those about the
constructor's arguments are raised at construction.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.models.blocks import conv2d_pooling_output_shape
from torch_admm_deconv_tpu_torch.models.layers_common import (
    Conv2d,
    ConvTranspose2d,
    Linear,
    _pair,
    _param,
    fold,
    unfold,
)

IntOrPair = Union[int, Tuple[int, int]]


class Conv1d(nn.Module):
    """Valid 1-D conv on (B, C, L), weight (out, in, k) on both sides, bias
    zero; the weight U(-b, b) with b = 1/sqrt(in * k) (JAX
    local_patch.py:32-57)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 use_bias: bool = True, *, device=None, generator=None):
        super().__init__()
        bound = math.sqrt(6.0 / (6.0 * in_channels * kernel_size))
        w = (torch.rand((out_channels, in_channels, kernel_size), generator=generator) * 2.0
             - 1.0) * bound
        self.weight = _param(w, device)
        self.bias = _param(torch.zeros(out_channels), device) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(x, self.weight, self.bias)


class PatchProcessor(nn.Module):
    """Learnable residual gate on one patch of ``patch_size``
    (JAX local_patch.py:60-101): a strided conv, a linear layer and two 1-D
    convs make a per-channel sigmoid gate; a transposed 5x5 conv, a 1x1 and
    a valid 5x5 conv make the residual; out = patch + residual * gate."""

    def __init__(self, channels: int, features_multiplier: int = 1,
                 downscale_kernel: IntOrPair = 1, downscale_stride: IntOrPair = 1,
                 *, patch_size: IntOrPair, device=None, generator=None):
        super().__init__()
        for name, v in (("downscale_kernel", downscale_kernel),
                        ("downscale_stride", downscale_stride)):
            vals = v if isinstance(v, tuple) else (v,)
            if any(k <= 0 for k in vals):
                raise ValueError(f"{name} entries must be positive")
        kw = dict(device=device, generator=generator)
        self.channels, self.fm = channels, features_multiplier
        oh, ow = conv2d_pooling_output_shape(_pair(patch_size), downscale_kernel,
                                             downscale_stride)
        fm = features_multiplier
        self.downscale = Conv2d(channels, channels, downscale_kernel, stride=downscale_stride,
                                **kw)
        self.linear = Linear(channels * oh * ow, channels * fm, **kw)
        self.conv1d_a_1 = Conv1d(channels, channels, fm, **kw)
        self.conv1d_a_2 = Conv1d(channels, channels, 1, **kw)
        self.conv2d_b_1 = ConvTranspose2d(channels, channels, 5, **kw)
        self.conv2d_b_2 = Conv2d(channels, channels, 1, **kw)
        self.conv2d_b_3 = Conv2d(channels, channels, 5, **kw)

    def forward(self, patch: torch.Tensor) -> torch.Tensor:
        b = patch.shape[0]
        flat = self.downscale(patch).reshape(b, -1)
        gated = self.linear(flat).reshape(b, -1, self.fm)
        gated = self.conv1d_a_2(self.conv1d_a_1(gated))
        gate = torch.sigmoid(gated).reshape(b, self.channels, 1, 1)
        res = self.conv2d_b_3(self.conv2d_b_2(self.conv2d_b_1(patch)))
        return patch + res * gate


class LocalAttentionPatch(nn.Module):
    """Unfold into ``patch_size`` patches at ``stride``, one
    ``PatchProcessor`` per patch, fold back with overlap-add
    (JAX local_patch.py:104-149)."""

    def __init__(self, patch_size: int, stride: int, num_processors: int, channels: int,
                 features_multiplier: int = 1, downscale_kernel: IntOrPair = 1,
                 downscale_stride: IntOrPair = 1, *, device=None, generator=None):
        super().__init__()
        if patch_size <= 0:
            raise ValueError("patch_size must be a positive integer")
        if stride <= 0:
            raise ValueError("stride must be a positive integer")
        if num_processors <= 0:
            raise ValueError("num_processors must be a positive integer")
        if features_multiplier <= 0:
            raise ValueError("features_multiplier must be a positive integer")
        self.patch_size, self.stride = patch_size, stride
        self.num_processors, self.channels = num_processors, channels
        device = resolve_device(device)
        for i in range(num_processors):
            self.add_module(f"processor_{i}", PatchProcessor(
                channels, features_multiplier, downscale_kernel, downscale_stride,
                patch_size=patch_size, device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 4:
            raise ValueError("LocalAttentionPatch expects input with shape (B, C, H, W)")
        b, c, h, w = x.shape
        if c != self.channels:
            raise ValueError(f"Expected {self.channels} input channels, received {c}")
        k, s = self.patch_size, self.stride
        rows = (h - k) // s + 1 if h >= k else 0
        cols = (w - k) // s + 1 if w >= k else 0
        num_patches = rows * cols
        if num_patches == 0:
            raise ValueError("No patches were extracted; check patch size and stride")
        if num_patches != self.num_processors:
            raise ValueError(
                f"Expected num processors to be same as {num_patches} patches, "
                f"but got {self.num_processors}"
            )
        per_patch = unfold(x, k, s).reshape(b, c, k, k, num_patches)
        processed = [getattr(self, f"processor_{i}")(per_patch[..., i])
                     for i in range(num_patches)]
        stacked = torch.stack(processed, dim=-1).reshape(b, -1, num_patches)
        return fold(stacked, (h, w), k, s)
