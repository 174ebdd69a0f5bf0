"""NAFNet ("Simple Baselines for Image Restoration", Chen et al. 2022), the
eval harness's comparison model, on NCHW.

Counterpart of torch_admm_deconv_tpu/models/nafnet.py (:37-182), with its
module and parameter names, so ``convert.flax_to_torch`` maps a Flax tree
onto it. ``NAFNetLocal`` is NAFNet with the TLSC test-time local statistics
(Chu et al. 2021): the simplified channel attention pools over a local
window instead of the whole map. The window is the one the original
calibration caches: ``train_feature_at_level * int(1.5 * train) // train``,
fixed whatever the inference size (``NAFNet._sca_kernel``). The blocks'
dropout, off (rate 0) wherever the JAX package builds a NAFNet, is not
ported. The convolutions are cuDNN's through ``F.conv2d``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torch_admm_deconv_tpu_torch.models.layers_common import (
    Conv2d,
    LayerNorm2d,
    _param,
    adaptive_avg_pool2d_1,
    pixel_shuffle,
)


def simple_gate(x: torch.Tensor) -> torch.Tensor:
    """The product of the two channel halves (JAX nafnet.py:37-39)."""
    x1, x2 = torch.chunk(x, 2, dim=1)
    return x1 * x2


def local_avg_pool2d(x: torch.Tensor, kernel: Tuple[int, int]) -> torch.Tensor:
    """TLSC local average pool by 2-D cumulative sums, edge-padded back to
    the input size (JAX nafnet.py:42-58)."""
    _, _, h, w = x.shape
    k1, k2 = min(h, kernel[0]), min(w, kernel[1])
    s = F.pad(x.cumsum(-1).cumsum(-2), (1, 0, 1, 0))
    s1 = s[:, :, :-k1, :-k2]
    s2 = s[:, :, :-k1, k2:]
    s3 = s[:, :, k1:, :-k2]
    s4 = s[:, :, k1:, k2:]
    out = (s4 + s1 - s2 - s3) / (k1 * k2)
    oh, ow = out.shape[-2:]
    pad = ((w - ow) // 2, (w - ow + 1) // 2, (h - oh) // 2, (h - oh + 1) // 2)
    return F.pad(out, pad, mode="replicate")


class NAFBlock(nn.Module):
    """LayerNorm, 1x1 expand, 3x3 depthwise, SimpleGate, simplified channel
    attention, 1x1 project, scaled by ``beta``; then LayerNorm, the gated
    1x1 feed-forward, scaled by ``gamma`` (JAX nafnet.py:61-108). ``beta``
    and ``gamma`` start at 0, so a fresh block is the identity."""

    def __init__(self, c: int, dw_expand: int = 2, ffn_expand: int = 2,
                 sca_local_kernel: Optional[Tuple[int, int]] = None, *, device=None,
                 generator=None):
        super().__init__()
        dw = c * dw_expand
        kw = dict(device=device, generator=generator)
        self.sca_local_kernel = sca_local_kernel
        self.norm1 = LayerNorm2d(c, device=device)
        self.conv1 = Conv2d(c, dw, 1, **kw)
        self.conv2 = Conv2d(dw, dw, 3, padding=1, groups=dw, **kw)
        self.sca_conv = Conv2d(dw // 2, dw // 2, 1, **kw)
        self.conv3 = Conv2d(dw // 2, c, 1, **kw)
        self.beta = _param(torch.zeros(1, c, 1, 1), device)
        self.norm2 = LayerNorm2d(c, device=device)
        self.conv4 = Conv2d(c, ffn_expand * c, 1, **kw)
        self.conv5 = Conv2d(ffn_expand * c // 2, c, 1, **kw)
        self.gamma = _param(torch.zeros(1, c, 1, 1), device)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        x = simple_gate(self.conv2(self.conv1(self.norm1(inp))))
        # global pool unless the TLSC window is smaller than the map
        kernel = self.sca_local_kernel
        if kernel is not None and (kernel[0] < x.shape[-2] or kernel[1] < x.shape[-1]):
            pooled = local_avg_pool2d(x, kernel)
        else:
            pooled = adaptive_avg_pool2d_1(x)
        x = self.conv3(x * self.sca_conv(pooled))
        y = inp + x * self.beta
        x = self.conv5(simple_gate(self.conv4(self.norm2(y))))
        return y + x * self.gamma


class NAFNet(nn.Module):
    """U-shaped NAFNet: intro conv, ``enc_blk_nums[i]`` blocks then a 2x2
    stride-2 conv per level, ``middle_blk_num`` blocks, then per level a 1x1
    conv, PixelShuffle(2), the skip and ``dec_blk_nums[i]`` blocks, an
    ending conv and the global residual (JAX nafnet.py:111-175). The input
    is zero-padded to a multiple of 2^levels and the output cropped back.
    ``train_size`` (h, w) turns on TLSC."""

    def __init__(self, img_channel: int = 3, width: int = 16, middle_blk_num: int = 1,
                 enc_blk_nums: Sequence[int] = (), dec_blk_nums: Sequence[int] = (),
                 train_size: Optional[Tuple[int, int]] = None, tlsc_ratio: float = 1.5, *,
                 device=None, generator=None):
        super().__init__()
        self.enc_blk_nums, self.dec_blk_nums = tuple(enc_blk_nums), tuple(dec_blk_nums)
        self.middle_blk_num = middle_blk_num
        self.train_size, self.tlsc_ratio = train_size, tlsc_ratio
        kw = dict(device=device, generator=generator)
        levels = len(self.enc_blk_nums)

        def block(name, chan, level):
            self.add_module(name, NAFBlock(chan, sca_local_kernel=self._sca_kernel(level), **kw))

        self.intro = Conv2d(img_channel, width, 3, padding=1, **kw)
        chan = width
        for li, num in enumerate(self.enc_blk_nums):
            for bi in range(num):
                block(f"enc_{li}_{bi}", chan, li)
            self.add_module(f"down_{li}", Conv2d(chan, 2 * chan, 2, stride=2, **kw))
            chan *= 2
        for bi in range(middle_blk_num):
            block(f"middle_{bi}", chan, levels)
        for li, num in enumerate(self.dec_blk_nums):
            self.add_module(f"up_{li}", Conv2d(chan, chan * 2, 1, use_bias=False, **kw))
            chan //= 2
            for bi in range(num):
                block(f"dec_{li}_{bi}", chan, levels - 1 - li)
        self.ending = Conv2d(width, img_channel, 3, padding=1, **kw)

    def _sca_kernel(self, level: int) -> Optional[Tuple[int, int]]:
        """The TLSC window of a block at ``level``, as the original's
        calibration computes and caches it: one forward at the train size
        (padded to a multiple of 2^levels), where each pool takes
        ``feature_size * int(train * ratio) // train`` (JAX nafnet.py:120-138)."""
        if self.train_size is None:
            return None
        th, tw = self.train_size
        padder = 2 ** len(self.enc_blk_nums)
        pth = th + (padder - th % padder) % padder
        ptw = tw + (padder - tw % padder) % padder
        base = (int(th * self.tlsc_ratio), int(tw * self.tlsc_ratio))
        feat = (pth // (2**level), ptw // (2**level))
        return (feat[0] * base[0] // th, feat[1] * base[1] // tw)

    def forward(self, inp: torch.Tensor) -> torch.Tensor:
        _, _, h, w = inp.shape
        padder = 2 ** len(self.enc_blk_nums)
        padded = F.pad(inp, (0, (padder - w % padder) % padder, 0, (padder - h % padder) % padder))
        x = self.intro(padded)
        encs = []
        for li, num in enumerate(self.enc_blk_nums):
            for bi in range(num):
                x = getattr(self, f"enc_{li}_{bi}")(x)
            encs.append(x)
            x = getattr(self, f"down_{li}")(x)
        for bi in range(self.middle_blk_num):
            x = getattr(self, f"middle_{bi}")(x)
        for li, num in enumerate(self.dec_blk_nums):
            x = pixel_shuffle(getattr(self, f"up_{li}")(x), 2) + encs[::-1][li]
            for bi in range(num):
                x = getattr(self, f"dec_{li}_{bi}")(x)
        x = self.ending(x) + padded
        return x[:, :, :h, :w]


def NAFNetLocal(train_size: Tuple[int, int] = (256, 256), **kwargs) -> NAFNet:
    """NAFNet with TLSC local statistics for large-image inference (JAX
    nafnet.py:178-182)."""
    return NAFNet(train_size=train_size, **kwargs)
