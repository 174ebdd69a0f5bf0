"""Sliding-window channel-wise variance maps.

Counterpart of torch_admm_deconv_tpu/models/varmap.py: the biased variance
E[x^2] - E[x]^2 of each zero-padded window, from two window means
(``F.avg_pool2d``, a plain float32 reduction that no TF32 setting touches).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def channelwise_variance(x: torch.Tensor, kernel_size: int = 3, stride: int = 1,
                         padding: int = 1) -> torch.Tensor:
    """(B, C, H, W) -> per-channel local variance map (B, C, H', W')
    (JAX varmap.py:16-37)."""
    xp = F.pad(x, (padding, padding, padding, padding))
    mean = F.avg_pool2d(xp, kernel_size, stride)
    mean_sq = F.avg_pool2d(xp * xp, kernel_size, stride)
    return mean_sq - mean * mean


class ChannelwiseVariance(nn.Module):
    """Module form of :func:`channelwise_variance`, no parameters
    (JAX varmap.py:40-46)."""

    def __init__(self, kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channelwise_variance(x, self.kernel_size, self.stride, self.padding)
