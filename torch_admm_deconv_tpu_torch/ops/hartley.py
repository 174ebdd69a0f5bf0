"""Hartley (cas) transform matrices for the whole-solve kernel's x-update.

The port's own copy of the helpers in torch_admm_deconv_tpu/ops/mxu_fft.py
(:150-257). The x-update spectrum 1/(|H|^2 + rho |D|^2) is real; when it is
even per axis (no PSF, or an axis-symmetric one) the separable cas transform
T_h v T_w diagonalizes it, otherwise the 2-D Hartley pair
(T_h v) C_w + (T_h' v) S_w does. The DFT-by-matmul functions of that module
exist only to work around the TPU's FFT and are not ported.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=32)
def _cas_mats_np(h: int, w: int):
    n_h = np.arange(h)
    ang_h = 2.0 * np.pi * np.outer(n_h, n_h) / h
    th = (np.cos(ang_h) + np.sin(ang_h)).astype(np.float32)  # symmetric
    n_w = np.arange(w)
    ang_w = 2.0 * np.pi * np.outer(n_w, n_w) / w
    tw = (np.cos(ang_w) + np.sin(ang_w)).astype(np.float32)
    return th, tw


@lru_cache(maxsize=32)
def _cas_pair_mats_np(h: int, w: int):
    th, _ = _cas_mats_np(h, w)
    thp = np.roll(th[::-1], 1, axis=0)  # thp[k] = th[(h - k) % h]
    n_w = np.arange(w)
    ang_w = 2.0 * np.pi * np.outer(n_w, n_w) / w
    return thp.astype(np.float32), np.cos(ang_w).astype(np.float32), np.sin(ang_w).astype(np.float32)


def cas_mats(h: int, w: int, device=None):
    """(T_h, T_w) with T_N[k, n] = cas(2 pi k n / N) (JAX mxu_fft.py:161-163)."""
    return tuple(torch.tensor(m, device=device) for m in _cas_mats_np(h, w))


def cas_pair_mats(h: int, w: int, device=None):
    """(T_h, T_h', C_w, S_w) for the general-PSF Hartley pair
    (JAX mxu_fft.py:210-214)."""
    th, _ = _cas_mats_np(h, w)
    return tuple(torch.tensor(m, device=device) for m in (th, *_cas_pair_mats_np(h, w)))


def mirror_freq_full_joint(freq_c: torch.Tensor, w: int) -> torch.Tensor:
    """(H, W//2+1) rfft-grid spectrum -> full (H, W) grid by the conjugate
    mirror full[k1, W-k2] = half[(H-k1) % H, k2] (JAX mxu_fft.py:173-181)."""
    body = freq_c[:, 1 : (w + 1) // 2]
    mirrored = torch.roll(torch.flip(body, dims=(0, 1)), 1, dims=0)
    return torch.cat([freq_c[:, : w // 2 + 1], mirrored], dim=-1)


def psf_is_axis_symmetric(kern) -> bool:
    """True when the PSF is even per axis (no PSF counts), so the 2-product
    cas transform is valid; conservative False otherwise
    (JAX mxu_fft.py:248-257)."""
    if kern is None or kern.numel() == 0:
        return True
    k = kern.detach().to("cpu", torch.float64).numpy()
    k = k.reshape(k.shape[-2], k.shape[-1])
    return bool(
        np.allclose(k, k[::-1, :], atol=1e-7) and np.allclose(k, k[:, ::-1], atol=1e-7)
    )
