"""ParallelUpsampleReduce: bicubic upsample, parallel strided convs, 1x1
fuse.

Counterpart of torch_admm_deconv_tpu/models/sra.py, with its validation
errors word for word; they are raised at construction here, where the JAX
module raises them at its first call.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.models.layers_common import Conv2d, interpolate_bicubic


class ParallelUpsampleReduce(nn.Module):
    """Upsample by ``scale_factor`` (JAX's cubic resize), run
    ``num_branches`` convs of odd kernel sizes at stride ``scale_factor``
    back to the input's size, concatenate, fuse with a 1x1 conv
    (JAX sra.py:18-66)."""

    def __init__(self, in_channels: int, scale_factor: int, num_branches: int,
                 branch_kernel_size: Union[int, Sequence[int]],
                 branch_channels: Optional[int] = None, branch_bias: bool = True,
                 final_bias: bool = True, activation: Optional[Callable] = None,
                 *, device=None, generator=None):
        super().__init__()
        ks = branch_kernel_size
        if isinstance(ks, int):
            ks = [ks] * num_branches
        elif len(ks) != num_branches:
            raise ValueError("branch_kernel_size must be an int or a list of length num_branches")
        else:
            # Flax holds a list attribute as a tuple, and the last error prints it
            ks = tuple(ks)
        if scale_factor < 1 or int(scale_factor) != scale_factor:
            raise ValueError("scale_factor must be a positive integer")
        if num_branches < 1:
            raise ValueError("num_branches must be >= 1")
        if any(k % 2 == 0 for k in ks):
            raise ValueError(
                f"branch_kernel_size must be odd to preserve alignment but got {ks}"
            )
        self.scale, self.activation, self.n = int(scale_factor), activation, len(ks)
        branch_channels = branch_channels or in_channels
        kw = dict(device=resolve_device(device), generator=generator)
        for i, k in enumerate(ks):
            self.add_module(f"branch_{i}", Conv2d(in_channels, branch_channels, k,
                                                  stride=self.scale, padding=k // 2,
                                                  use_bias=branch_bias, **kw))
        self.final_conv = Conv2d(branch_channels * num_branches, in_channels, 1,
                                 use_bias=final_bias, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = interpolate_bicubic(x, self.scale)
        fused = torch.cat([getattr(self, f"branch_{i}")(up) for i in range(self.n)], dim=1)
        out = self.final_conv(fused)
        return self.activation(out) if self.activation else out
