"""Inference: restore arbitrary-size images by overlap-discard tiling.

Counterpart of torch_admm_deconv_tpu/infer.py. The image is reflect-padded
and cut into fixed ``tile x tile`` windows overlapping by ``margin`` pixels;
tiles go through the apply function in batches of one fixed shape, and only
the centre ``tile - 2*margin`` core of each output tile is kept.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.utils import tracing

Array = np.ndarray


def _pad_reflect(img: Array, top: int, bottom: int, left: int, right: int) -> Array:
    return np.pad(img, ((0, 0), (top, bottom), (left, right)), mode="reflect")


def tiled_apply(apply_fn: Callable, img_chw: Array, *, tile: int = 256, margin: int = 32,
                max_batch: int = 8) -> Array:
    """Apply a (B, C, tile, tile) -> (B, C, tile, tile) function to a
    (C, H, W) image by overlap-discard tiling (JAX infer.py:40-113).
    ``margin`` must exceed the effective receptive field of ``apply_fn``;
    every call gets exactly ``max_batch`` tiles (the last batch is padded
    with zeros)."""
    if img_chw.ndim != 3:
        raise ValueError(f"expected (C, H, W), got {img_chw.shape}")
    if not 0 <= 2 * margin < tile:
        raise ValueError(f"need 0 <= 2*margin < tile, got tile={tile} margin={margin}")
    c, h, w = img_chw.shape
    core = tile - 2 * margin

    ny = max(1, math.ceil(h / core))
    nx = max(1, math.ceil(w / core))
    # reflect-pad to margin + ny*core + margin; np.pad(reflect) caps each pad
    # at dim-1, so grow in rounds for tiny images
    need_b = ny * core - h + margin
    need_r = nx * core - w + margin
    padded = img_chw
    top, left = margin, margin
    while top > 0 or need_b > 0 or left > 0 or need_r > 0:
        t = min(top, padded.shape[1] - 1)
        b = min(max(need_b, 0), padded.shape[1] - 1)
        le = min(left, padded.shape[2] - 1)
        r = min(max(need_r, 0), padded.shape[2] - 1)
        if t == b == le == r == 0:  # 1-pixel dims: reflect can't grow, edge pad
            padded = np.pad(padded, ((0, 0), (top, max(need_b, 0)), (left, max(need_r, 0))),
                            mode="edge")
            break
        padded = _pad_reflect(padded, t, b, le, r)
        top -= t
        need_b -= b
        left -= le
        need_r -= r

    tiles = np.empty((ny * nx, c, tile, tile), img_chw.dtype)
    for iy in range(ny):
        for ix in range(nx):
            y0, x0 = iy * core, ix * core
            tiles[iy * nx + ix] = padded[:, y0 : y0 + tile, x0 : x0 + tile]

    outs = np.empty_like(tiles)
    n = tiles.shape[0]
    for s in range(0, n, max_batch):
        batch = tiles[s : s + max_batch]
        if batch.shape[0] < max_batch:  # keep one batch shape
            batch = np.concatenate(
                [batch, np.zeros((max_batch - batch.shape[0],) + batch.shape[1:], batch.dtype)]
            )
        outs[s : s + max_batch] = np.asarray(apply_fn(batch))[: min(max_batch, n - s)]

    result = np.empty((c, ny * core, nx * core), img_chw.dtype)
    for iy in range(ny):
        for ix in range(nx):
            t = outs[iy * nx + ix]
            result[:, iy * core : (iy + 1) * core, ix * core : (ix + 1) * core] = t[
                :, margin : margin + core, margin : margin + core
            ]
    return result[:, :h, :w]


def classical_restorer(lmbd: float = 0.05, rho: float = 1.0, maxit: int = 100, iso: bool = True,
                       kern: Optional[np.ndarray] = None, use_pallas: bool = True,
                       *, device=None) -> Callable:
    """Batch apply_fn (numpy in, numpy out) for the classical TV-ADMM solver
    (JAX infer.py:116-138). ``device``: ``None`` means CUDA."""
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv

    dev = resolve_device(device)
    k = None if kern is None else torch.as_tensor(np.asarray(kern, np.float32), device=dev)

    def apply_fn(batch):
        with tracing.span("request", batch=np.shape(batch)), torch.inference_mode():
            with tracing.span("entry.to_device"):
                x = torch.as_tensor(np.asarray(batch), device=dev)
            out = admm_tv(x, lmbd, rho, k, iso=iso, maxit=maxit, use_pallas=use_pallas, device=dev)
            with tracing.span("entry.to_host"):
                return out.cpu().numpy()

    return apply_fn


def model_restorer(state_dict: Mapping[str, torch.Tensor], model=None, *, device=None) -> Callable:
    """Batch apply_fn from a state dict (e.g. ``convert.flax_to_torch`` of a
    JAX checkpoint; JAX infer.py:141-157). ``model`` defaults to the
    flagship DivergentRestorer with the whole-solve kernel."""
    dev = resolve_device(device)
    if model is None:
        from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer

        model = flagship_divergent_restorer(remat=False, use_pallas=True, device=dev)
    model.load_state_dict(state_dict)
    model.to(dev).eval()

    def apply_fn(batch):
        with tracing.span("request", batch=np.shape(batch)), torch.inference_mode():
            with tracing.span("entry.to_device"):
                x = torch.as_tensor(np.asarray(batch), device=dev)
            with tracing.span("model.forward"):
                out = model(x)
            with tracing.span("entry.to_host"):
                return out.cpu().numpy()

    return apply_fn


def restore_image(apply_fn: Callable, img_chw: Array, *, tile: int = 256, margin: int = 32,
                  max_batch: int = 8) -> Array:
    """Restore one (C, H, W) float image in [0, 1]; output clipped to [0, 1]
    (JAX infer.py:160-172)."""
    out = tiled_apply(apply_fn, np.asarray(img_chw, np.float32), tile=tile, margin=margin,
                      max_batch=max_batch)
    return np.clip(out, 0.0, 1.0)
