"""Paired-image data: host transforms, the image-folder dataset, the loader."""

from torch_admm_deconv_tpu_torch.data.dataset import (  # noqa: F401
    DataLoader,
    ImageDataset,
    read_image_chw,
)
from torch_admm_deconv_tpu_torch.data.transforms import (  # noqa: F401
    AddAWGN,
    CircBlur,
    RandCrop,
    Scale,
    gaussian_psf_np,
)
