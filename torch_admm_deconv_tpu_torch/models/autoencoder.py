"""U-Net-like autoencoder with skip concatenations.

Counterpart of torch_admm_deconv_tpu/models/autoencoder.py: the encoder is a
chain of ``DownBlock``s that keeps every output, the decoder a chain of
``UpBlock``s over the reversed encoder outputs, each after the first taking
its skip concatenated with the previous output.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.models.blocks import (
    DownBlock,
    UpBlock,
    compute_enc_input_channels,
    compute_residual_dec_input_channels,
)

IntOrPair = Union[int, Tuple[int, int]]


class Encoder(nn.Module):
    """``DownBlock``s ``block_{i}``; returns every block's output
    (JAX autoencoder.py:26-41)."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel_sizes: Sequence[IntOrPair], activation: Optional[Callable] = None,
                 pool_size: int = 0, *, device=None, generator=None):
        super().__init__()
        self.n = len(list(zip(in_channels, out_channels, kernel_sizes)))
        for i, (ic, oc, ks) in enumerate(zip(in_channels, out_channels, kernel_sizes)):
            self.add_module(f"block_{i}", DownBlock(ic, oc, ks, activation, None, pool_size,
                                                    device=device, generator=generator))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        for i in range(self.n):
            x = getattr(self, f"block_{i}")(x)
            outs.append(x)
        return outs


class Decoder(nn.Module):
    """``UpBlock``s ``block_{i}`` over the reversed list of encoder outputs
    (JAX autoencoder.py:44-75)."""

    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 kernel_sizes: Sequence[IntOrPair], activation: Optional[Callable] = None,
                 pool_size: int = 0, *, device=None, generator=None):
        super().__init__()
        self.n = len(in_channels)
        for i in range(self.n):
            self.add_module(f"block_{i}", UpBlock(in_channels[i], out_channels[i],
                                                  kernel_sizes[i], activation, None, pool_size,
                                                  device=device, generator=generator))

    def forward(self, xs: List[torch.Tensor]) -> torch.Tensor:
        xs = xs[::-1]
        out = self.block_0(xs[0])
        for i in range(1, len(xs)):
            out = getattr(self, f"block_{i}")(torch.cat([xs[i], out], dim=1))
        return out


class Autoencoder(nn.Module):
    """``encoder`` then ``decoder``, the widths from the blocks.py helpers
    (JAX autoencoder.py:78-105)."""

    def __init__(self, in_channels: int, enc_out_channels: Sequence[int],
                 dec_out_channels: Sequence[int], kernel_sizes: Sequence[IntOrPair],
                 activation: Optional[Callable] = None, pool_size: int = 0,
                 *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        enc_in = compute_enc_input_channels(in_channels, list(enc_out_channels))
        dec_in = compute_residual_dec_input_channels(list(enc_out_channels),
                                                     list(dec_out_channels))
        self.encoder = Encoder(enc_in, enc_out_channels, kernel_sizes, activation, pool_size,
                               **kw)
        self.decoder = Decoder(dec_in, dec_out_channels, list(kernel_sizes)[::-1], activation,
                               pool_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(x))
