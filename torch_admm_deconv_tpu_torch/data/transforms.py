"""Paired-image transforms on the host, with an explicit numpy Generator.

Counterpart of torch_admm_deconv_tpu/data/transforms.py (:18-108), copied:
``RandCrop``, ``Scale``, ``CircBlur``, ``gaussian_psf_np`` and ``AddAWGN``
run on host numpy inside the loader; every random transform draws from the
``np.random.Generator`` it is given, so a seed fixes the batches.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


class RandCrop:
    """Identical random crop applied to both images."""

    def __init__(self, im_shape: Union[int, Tuple[int, int]]):
        assert isinstance(im_shape, (int, tuple, list))
        self.im_shape = (im_shape, im_shape) if isinstance(im_shape, int) else tuple(im_shape)
        assert len(self.im_shape) == 2

    def __call__(self, x_img: np.ndarray, y_img: np.ndarray, rng: np.random.Generator):
        _, h, w = y_img.shape
        new_h, new_w = self.im_shape
        top = int(rng.integers(0, h - new_h + 1))
        left = int(rng.integers(0, w - new_w + 1))
        return (
            x_img[:, top : top + new_h, left : left + new_w],
            y_img[:, top : top + new_h, left : left + new_w],
        )


class Scale:
    """/255 on both images."""

    def __call__(self, x_img, y_img, rng=None):
        return x_img / 255.0, y_img / 255.0


class CircBlur:
    """Circular (periodic-boundary) blur of the degraded input with a fixed
    PSF, the non-blind deblur protocol. Uses the same centered-OTF
    convention as the solver's forward operator H (``ops/fdops.py``), so a
    solver given this PSF inverts the exact degradation. Applied to x only."""

    def __init__(self, psf: np.ndarray):
        psf = np.asarray(psf, np.float32)
        self.psf = psf.reshape(psf.shape[-2], psf.shape[-1])

    def __call__(self, x_img: np.ndarray, y_img: np.ndarray, rng=None):
        h, w = x_img.shape[-2:]
        kh, kw = self.psf.shape
        top, left = (kh - 1) // 2, (kw - 1) // 2
        padded = np.zeros((h, w), np.float32)
        padded[:kh, :kw] = self.psf
        otf = np.fft.rfft2(np.roll(padded, (-top, -left), axis=(0, 1)))
        blurred = np.fft.irfft2(
            np.fft.rfft2(x_img, axes=(-2, -1)) * otf, s=(h, w), axes=(-2, -1)
        ).astype(x_img.dtype)
        return blurred, y_img


def gaussian_psf_np(size: int = 9, sigma: float = 1.5) -> np.ndarray:
    """Normalized 2-D Gaussian PSF (the deblur protocol's kernel)."""
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


class AddAWGN:
    """Additive white gaussian noise with sigma drawn from
    ``std_range``/255; ``both`` adds the same noise to the target too."""

    def __init__(
        self,
        mean: float = 0.0,
        std_range: Tuple[int, int] = (1, 1),
        minval: float = 0.0,
        maxval: float = 1.0,
        both: bool = False,
    ):
        self.mean = mean
        self.std_range = std_range
        self.minval = minval
        self.maxval = maxval
        self.both = both

    def __call__(self, x_img: np.ndarray, y_img: np.ndarray, rng: np.random.Generator):
        lo, hi = self.std_range
        # reference uses torch.randint(lo, hi) => hi exclusive; degenerate
        # ranges fall back to lo
        std = float(rng.integers(lo, max(hi, lo + 1))) / 255.0
        noise = rng.standard_normal(x_img.shape).astype(x_img.dtype) * std + self.mean
        xo = np.clip(x_img + noise, self.minval, self.maxval)
        if self.both:
            yo = np.clip(y_img + noise, self.minval, self.maxval)
            return xo, yo
        return xo, y_img
