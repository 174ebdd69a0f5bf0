"""Image quality metrics and the training losses."""

from torch_admm_deconv_tpu_torch.metrics import functional  # noqa: F401
from torch_admm_deconv_tpu_torch.metrics.color import rgb_to_grayscale, rgb_to_lab  # noqa: F401
from torch_admm_deconv_tpu_torch.metrics.functional import (  # noqa: F401
    mae,
    ms_ssim,
    mse,
    psnr,
    scc,
    ssim,
    uiq,
)
from torch_admm_deconv_tpu_torch.metrics.losses import (  # noqa: F401
    MSE,
    MAELoss,
    Metric,
    MSSSIMLoss,
    MSSSIMMetric,
    PSNRLoss,
    PSNRMetric,
    SCCMetric,
    SSIMLabColorLoss,
    SSIMLoss,
    SSIMMetric,
    UIQMetric,
)
