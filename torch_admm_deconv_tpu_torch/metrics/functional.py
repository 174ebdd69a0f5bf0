"""Image quality metrics: MSE, MAE, PSNR, SSIM, MS-SSIM, UIQ, SCC.

Counterpart of torch_admm_deconv_tpu/metrics/functional.py (:29-188), with
the same conventions: SSIM uses a gaussian window (kernel 11, sigma 1.5 by
default; the training loss uses kernel 7) over valid windows; PSNR reduces
the MSE over the whole batch; UIQ is the Wang-Bovik index with a gaussian
window; SCC high-pass filters with the 3x3 laplacian, then correlates over
a uniform window of 8. All functions take NCHW float tensors in
[0, data_range].

Every windowed moment computes a variance as E[x^2] - mu^2, a cancellation
that a TF32 convolution (10-bit mantissa) turns into garbage: on the TPU the
bf16 equivalent drove the training loss to -30 and then NaN. So the windows
run in full float32 in the forward and the backward pass, whatever the
global TF32 flags say (``_depthwise``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


@contextmanager
def _no_tf32():
    """cuDNN convolutions in full float32 inside the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class _Depthwise(torch.autograd.Function):
    """Depthwise (``groups=C``) correlation with a (C, 1, kh, kw) weight and
    zero padding, TF32 off in both passes (autograd would run the backward
    convolution under whatever flags hold when it runs)."""

    @staticmethod
    def forward(ctx, x, weight, padding):
        ctx.save_for_backward(weight)
        ctx.padding, ctx.shape = padding, x.shape
        with _no_tf32():
            return F.conv2d(x, weight, padding=padding, groups=x.shape[1])

    @staticmethod
    def backward(ctx, grad):
        (weight,) = ctx.saved_tensors
        with _no_tf32():
            gx = torch.nn.grad.conv2d_input(ctx.shape, weight, grad, padding=ctx.padding,
                                            groups=weight.shape[0])
        return gx, None, None


def _depthwise(x: torch.Tensor, kernel2d: torch.Tensor, padding=0) -> torch.Tensor:
    c = x.shape[1]
    weight = kernel2d.to(x.dtype)[None, None].expand(c, 1, *kernel2d.shape).contiguous()
    return _Depthwise.apply(x, weight, padding)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(data_range**2 / mse(pred, target))


def psnr_np(pred: np.ndarray, target: np.ndarray, data_range: float = 1.0) -> float:
    """:func:`psnr` of two NumPy arrays, in their own precision."""
    return float(10.0 * np.log10(data_range**2 / np.mean((pred - target) ** 2)))


def _gaussian_kernel1d(size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    ax = torch.arange(size, dtype=like.dtype, device=like.device) - (size - 1) / 2.0
    g = torch.exp(-(ax**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _uniform_kernel1d(size: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((size,), 1.0 / size, dtype=like.dtype, device=like.device)


def _windowed_means(x: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
    """Separable valid-window weighted mean over the last two axes of NCHW."""
    x = _depthwise(x, kernel1d[:, None])
    return _depthwise(x, kernel1d[None, :])


def _ssim_map(pred, target, kernel1d, data_range: float, k1: float = 0.01,
              k2: float = 0.03) -> Tuple[torch.Tensor, torch.Tensor]:
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _windowed_means(pred, kernel1d)
    mu_y = _windowed_means(target, kernel1d)
    mu_xx = _windowed_means(pred * pred, kernel1d)
    mu_yy = _windowed_means(target * target, kernel1d)
    mu_xy = _windowed_means(pred * target, kernel1d)
    var_x = mu_xx - mu_x * mu_x
    var_y = mu_yy - mu_y * mu_y
    cov = mu_xy - mu_x * mu_y
    cs = (2.0 * cov + c2) / (var_x + var_y + c2)
    ssim_map = ((2.0 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)) * cs
    return ssim_map, cs


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    k = _gaussian_kernel1d(kernel_size, sigma, pred)
    m, _ = _ssim_map(pred, target, k, data_range)
    return torch.mean(m)


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
            kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003), 5 scales with the standard
    weights; 2x average-pool downsampling between scales."""
    k = _gaussian_kernel1d(kernel_size, sigma, pred)
    vals = []
    p, t = pred, target
    n_scales = len(_MSSSIM_WEIGHTS)
    for i in range(n_scales):
        m, cs = _ssim_map(p, t, k, data_range)
        vals.append(torch.mean(m) if i == n_scales - 1 else torch.mean(cs))
        if i < n_scales - 1:
            p = F.avg_pool2d(p, 2)
            t = F.avg_pool2d(t, 2)
    total = torch.ones((), dtype=pred.dtype, device=pred.device)
    for v, w in zip(vals, _MSSSIM_WEIGHTS):
        total = total * torch.relu(v) ** w
    return total


def uiq(pred: torch.Tensor, target: torch.Tensor, kernel_size: int = 11,
        sigma: float = 1.5) -> torch.Tensor:
    """Universal Image Quality index (Wang & Bovik 2002), gaussian-windowed."""
    k = _gaussian_kernel1d(kernel_size, sigma, pred)
    mu_x = _windowed_means(pred, k)
    mu_y = _windowed_means(target, k)
    var_x = _windowed_means(pred * pred, k) - mu_x * mu_x
    var_y = _windowed_means(target * target, k) - mu_y * mu_y
    cov = _windowed_means(pred * target, k) - mu_x * mu_y
    num = 4.0 * cov * mu_x * mu_y
    den = (var_x + var_y) * (mu_x * mu_x + mu_y * mu_y)
    eps = torch.finfo(pred.dtype).eps
    return torch.mean(num / (den + eps))


def scc(pred: torch.Tensor, target: torch.Tensor, window_size: int = 8) -> torch.Tensor:
    """Spatial Correlation Coefficient: laplacian high-pass both images,
    then windowed Pearson correlation, averaged."""
    # the 3x3 laplacian, made on the device (no copy from the host)
    hp = torch.full((3, 3), -1.0, dtype=pred.dtype, device=pred.device)
    hp[1, 1] = 8.0
    fx = _depthwise(pred, hp, padding=1)
    fy = _depthwise(target, hp, padding=1)
    k = _uniform_kernel1d(window_size, pred)
    mu_x = _windowed_means(fx, k)
    mu_y = _windowed_means(fy, k)
    var_x = _windowed_means(fx * fx, k) - mu_x * mu_x
    var_y = _windowed_means(fy * fy, k) - mu_y * mu_y
    cov = _windowed_means(fx * fy, k) - mu_x * mu_y
    eps = torch.finfo(pred.dtype).eps
    prod = var_x * var_y
    corr = cov / torch.sqrt(torch.maximum(prod, prod.new_zeros(())) + eps)
    return torch.mean(corr)
