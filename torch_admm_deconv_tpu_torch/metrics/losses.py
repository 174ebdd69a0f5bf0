"""Metric and loss classes with the reference's ``Metric`` surface.

Counterpart of torch_admm_deconv_tpu/metrics/losses.py (:17-170): each class
carries ``m_name`` (the CSV column names depend on it, typo included) and is
called as ``metric(y_pred, y_true)``. The ``device`` constructor argument is
kept for the reference's signature; tensors carry their own device.
"""

from __future__ import annotations

import math

import torch

from torch_admm_deconv_tpu_torch.metrics import functional as F
from torch_admm_deconv_tpu_torch.metrics.color import rgb_to_lab


class Metric:
    m_name: str = "metric"

    def __init__(self, device=None):
        self.device = device

    def __call__(self, y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class MSE(Metric):
    m_name = "mse"

    def __call__(self, y_pred, y_true):
        return F.mse(y_pred, y_true)


class MAELoss(Metric):
    m_name = "mae_loss"

    def __call__(self, y_pred, y_true):
        return F.mae(y_pred, y_true)


class SSIMLoss(Metric):
    """1 - SSIM with kernel 7."""

    m_name = "ssim_loss"

    def __init__(self, device=None, data_range: float = 1.0, kern_size: int = 7):
        super().__init__(device)
        self.data_range = data_range
        self.kern_size = kern_size

    def __call__(self, y_pred, y_true):
        return 1.0 - F.ssim(y_pred, y_true, self.data_range, self.kern_size)


class SSIMMetric(Metric):
    m_name = "ssim"

    def __init__(self, device=None, data_range: float = 1.0):
        super().__init__(device)
        self.data_range = data_range

    def __call__(self, y_pred, y_true):
        return F.ssim(y_pred, y_true, self.data_range)


class MSSSIMLoss(Metric):
    m_name = "mssssim_loss"  # the reference's typo, kept for its CSV columns

    def __init__(self, device=None, data_range: float = 1.0):
        super().__init__(device)
        self.data_range = data_range

    def __call__(self, y_pred, y_true):
        return 1.0 - F.ms_ssim(y_pred, y_true, self.data_range)


class MSSSIMMetric(Metric):
    m_name = "msssim"

    def __init__(self, device=None, data_range: float = 1.0):
        super().__init__(device)
        self.data_range = data_range

    def __call__(self, y_pred, y_true):
        return F.ms_ssim(y_pred, y_true, self.data_range)


class PSNRMetric(Metric):
    m_name = "psnr"

    def __init__(self, device=None, data_range: float = 1.0):
        super().__init__(device)
        self.data_range = data_range

    def __call__(self, y_pred, y_true):
        return F.psnr(y_pred, y_true, self.data_range)


class UIQMetric(Metric):
    m_name = "uiq"

    def __call__(self, y_pred, y_true):
        return F.uiq(y_pred, y_true)


class SCCMetric(Metric):
    m_name = "scc"

    def __call__(self, y_pred, y_true):
        return F.scc(y_pred, y_true)


_Y_COEF = (65.481, 128.553, 24.966)  # BT.601 luma of [0, 1] RGB, scaled to [16, 235]


class PSNRLoss(Metric):
    """10*log10 of per-image MSE, averaged (nafnet-style). ``to_y``
    converts to the Y channel with the BT.601 coefficients first."""

    m_name = "psnr_loss"

    def __init__(self, device=None, to_y: bool = False):
        super().__init__(device)
        self.loss_weight = 1.0
        self.to_y = to_y

    @staticmethod
    def _luma(x):
        return (_Y_COEF[0] * x[:, 0:1] + _Y_COEF[1] * x[:, 1:2] + _Y_COEF[2] * x[:, 2:3]
                + 16.0) / 255.0

    def __call__(self, y_pred, y_true):
        if y_pred.ndim != 4:
            raise ValueError(f"expected NCHW, got {tuple(y_pred.shape)}")
        pred, target = y_pred, y_true
        if self.to_y:
            pred, target = self._luma(pred), self._luma(target)
        scale = 10.0 / math.log(10.0)
        per_image = torch.mean((pred - target) ** 2, dim=(1, 2, 3))
        return self.loss_weight * scale * torch.mean(torch.log(per_image + 1e-8))


class SSIMLabColorLoss(Metric):
    """Weighted (1 - SSIM) + L1 in CIELAB, the training loss. Weights
    1.3 / 0.9 / 0.3."""

    m_name = "color_lab_loss"

    def __init__(self, device=None, ssim_weight: float = 1.3, color_weight_ab: float = 0.9,
                 color_weight_l: float = 0.3):
        super().__init__(device)
        self.ssim_weight = ssim_weight
        self.color_weight_ab = color_weight_ab
        self.color_weight_l = color_weight_l
        self._ssim_loss = SSIMLoss(device)

    def __call__(self, y_pred, y_true):
        ssim_val = self._ssim_loss(y_pred, y_true)
        lab_pred = rgb_to_lab(y_pred)
        lab_true = rgb_to_lab(y_true)
        loss_l = torch.mean(torch.abs(lab_pred[:, 0] - lab_true[:, 0])) / 100.0
        loss_a = torch.mean(torch.abs(lab_pred[:, 1] - lab_true[:, 1])) / 200.0
        loss_b = torch.mean(torch.abs(lab_pred[:, 2] - lab_true[:, 2])) / 200.0
        color_ab = (loss_a + loss_b) / 2.0
        if self.color_weight_l <= 0:
            loss_l = 0.0
        return (self.ssim_weight * ssim_val + self.color_weight_ab * color_ab
                + self.color_weight_l * loss_l)
