"""UpDownScale and the Restorer fusion model.

Counterpart of torch_admm_deconv_tpu/models/restorer.py, which implements
the reference's two models (dead on arrival there) with their intended
wiring.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.metrics.color import clip
from torch_admm_deconv_tpu_torch.models.autoencoder import Autoencoder
from torch_admm_deconv_tpu_torch.models.blocks import (
    UpDownBlock,
    compute_enc_input_channels,
    compute_residual_dec_input_channels,
)
from torch_admm_deconv_tpu_torch.models.fusion import Deconvs


def relu6(v: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(jax.nn.relu(v), 0, 6)`` with JAX's gradient: ``clip``
    splits it at the ties, where ``torch.clamp`` passes all of it."""
    return clip(F.relu(v), 0.0, 6.0)


class UpDownScale(nn.Module):
    """Two halves of ``UpDownBlock``s, ``first_{i}`` and ``second_{i}``, the
    second over the reversed outputs of the first with skip concatenations
    (JAX restorer.py:23-63)."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 kernel_sizes: Sequence[int], activation: Optional[Callable] = None,
                 *, device=None, generator=None):
        super().__init__()
        if len(out_channels) != len(kernel_sizes):
            raise ValueError("out_channels and kernel_sizes must have the same length")
        if len(out_channels) % 2:
            raise ValueError("Module must have even number of blocks")
        kw = dict(device=resolve_device(device), generator=generator)
        half = len(out_channels) // 2
        self.half = half
        first_out = list(out_channels[:half])
        first_in = compute_enc_input_channels(in_channels, first_out)
        sec_out = list(out_channels[half:])
        sec_in = compute_residual_dec_input_channels(first_out, sec_out)
        for i, (ic, oc, ks) in enumerate(zip(first_in, first_out, kernel_sizes[:half])):
            self.add_module(f"first_{i}", UpDownBlock(ic, oc, oc, ks, activation, **kw))
        for i, (ic, oc, ks) in enumerate(zip(sec_in, sec_out, kernel_sizes[half:])):
            self.add_module(f"second_{i}", UpDownBlock(ic, oc, oc, ks, activation, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats: List[torch.Tensor] = []
        h = x
        for i in range(self.half):
            h = getattr(self, f"first_{i}")(h)
            feats.append(h)
        feats = feats[::-1]
        out = self.second_0(feats[0])
        for i in range(1, len(feats)):
            out = getattr(self, f"second_{i}")(torch.cat([feats[i], out], dim=1))
        return out


class Restorer(nn.Module):
    """``Deconvs`` front end, then [autoencoder | the deconvolutions |
    updownscale] concatenated into an ``UpDownBlock`` output block with
    ReLU6 (JAX restorer.py:66-88)."""

    def __init__(self, inc_channels: int, autoencoder_args: Dict, updownscale_args: Dict,
                 deconvs_args: Sequence[Dict], *, device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.deconvs = Deconvs(deconvs_args, **kw)
        self.autoencoder = Autoencoder(**autoencoder_args, **kw)
        self.updownscale = UpDownScale(**updownscale_args, **kw)
        last_in = (autoencoder_args["dec_out_channels"][-1]
                   + updownscale_args["out_channels"][-1]
                   + len(deconvs_args) * inc_channels)
        self.out_block = UpDownBlock(last_in, last_in // 2, inc_channels, 7, activation=relu6,
                                     **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        deconv_out = self.deconvs(x)
        comb = torch.cat([self.autoencoder(deconv_out), deconv_out,
                          self.updownscale(deconv_out)], dim=1)
        return self.out_block(comb)
