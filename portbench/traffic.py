"""The one traffic generator: a mix is a JSON file of parameters under
``traffic/``, and this module turns it and ``--seed`` into the pool of host
batches that a cell's client sends, back to back and in turn.

Keys of a mix:
  batch, channels, size   each request is a float32 (batch, channels, size,
                          size) array on the host
  pool                    how many distinct requests the seed makes; the
                          client cycles through them
  scene                   'blocks': the piecewise-smooth scenes TV
                          restoration targets (a coarse 8x8 field of
                          random levels, six random rectangles an image,
                          texture noise of 0.01), bench.py's ``_scene``
  blur                    'config_psf' blurs each scene circularly with the
                          configuration's PSF (centred at ((k-1)//2,
                          (k-1)//2)); absent or null: no blur
  noise_sigma             AWGN standard deviation, or
  noise_sigma_255         [lo, hi): an integer drawn per image in
                          [lo, hi) over 255, as the eval protocol's
                          AddAWGN draws it
  clip                    [lo, hi] the degraded batch is clipped to

Every seed gets the same sizes and the same amount of work; only the
content differs.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the seed (any integer)."""
    return np.random.default_rng([seed & MASK64, stream])


def blocks_scene(rng: np.random.Generator, batch: int, channels: int, size: int) -> np.ndarray:
    coarse = rng.standard_normal((batch, channels, 8, 8))
    img = 0.5 + 0.15 * coarse.repeat(size // 8, 2).repeat(size // 8, 3)
    for b in range(batch):
        for _ in range(6):
            y0, x0 = rng.integers(0, size - size // 4, 2)
            hh, ww = rng.integers(size // 16, size // 4, 2)
            img[b, :, y0 : y0 + hh, x0 : x0 + ww] = rng.random(channels)[:, None, None]
    img += 0.01 * rng.standard_normal(img.shape)
    return np.clip(img, 0.0, 1.0)


def circular_blur(img: np.ndarray, psf: np.ndarray) -> np.ndarray:
    """Circular convolution of each (H, W) plane with the (kh, kw) PSF."""
    h, w = img.shape[-2:]
    kh, kw = psf.shape[-2:]
    pad = np.zeros((h, w))
    pad[:kh, :kw] = psf.reshape(kh, kw)
    pad = np.roll(pad, (-((kh - 1) // 2), -((kw - 1) // 2)), axis=(0, 1))
    return np.fft.irfft2(np.fft.rfft2(img) * np.fft.rfft2(pad), s=(h, w))


def make_pool(mix: dict, seed: int, psf: np.ndarray | None = None) -> list:
    """The ``pool`` requests of ``mix`` for ``seed``, float32 host arrays."""
    if mix["scene"] != "blocks":
        raise ValueError(f"unknown scene {mix['scene']!r}")
    rng = rng_for(seed, 0)
    pool = []
    for _ in range(mix["pool"]):
        img = blocks_scene(rng, mix["batch"], mix["channels"], mix["size"])
        if mix.get("blur") == "config_psf":
            if psf is None:
                raise ValueError("the mix blurs with the configuration's PSF, which has none")
            img = circular_blur(img, psf)
        elif mix.get("blur") is not None:
            raise ValueError(f"unknown blur {mix['blur']!r}")
        if "noise_sigma_255" in mix:
            lo, hi = mix["noise_sigma_255"]
            sigma = rng.integers(lo, max(hi, lo + 1), size=(mix["batch"], 1, 1, 1)) / 255.0
        else:
            sigma = mix["noise_sigma"]
        img = img + sigma * rng.standard_normal(img.shape)
        lo, hi = mix["clip"]
        pool.append(np.clip(img, lo, hi).astype(np.float32))
    return pool
