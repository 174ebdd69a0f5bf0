"""The spatial gates' per-pixel median and mode across channels (CUDA,
``csrc/channel_pool.cu``).

Replaces no TPU kernel: the JAX package sorts (models/attention.py:229-244)
and XLA fuses the sort on the TPU; on the card the same code is a key-value
sort, a scan and int64 passes. The kernel reads each float32 value once and
writes the two planes, with the sort path's semantics: the median is the
element at (C - 1) // 2 of the ascending order, the mode the value of the
longest run of equal values there (ties toward the smallest), NaN after
+inf and a run of its own, -0 and +0 one run (returned as +0).

A CUDA tensor launches the kernel for 1 <= C <= ``MAX_CHANNELS`` and raises
above; there is no fallback. The plain version, which a CPU tensor runs, is
``models.attention.channel_pool_plain``. Under autograd the kernel also
writes the channel of each selected element (the median's by its stable
rank, the mode's as the first channel of its run) and the backward adds the
two gradients there, as ``torch.sort``'s gradient does.
"""

from __future__ import annotations

import ctypes

import torch

from torch_admm_deconv_tpu_torch.kernels._build import LIBRARIES, LaunchCounter, check
from torch_admm_deconv_tpu_torch.utils import tracing

LAUNCHES = LaunchCounter()
MAX_CHANNELS = 256

_VP = ctypes.c_void_p
_I = ctypes.c_int
# channel_pool_select(x, med, mode, med_idx, mode_idx, b, c, hw, stream)
ARGTYPES = [_VP] * 5 + [_I] * 3 + [_VP]


def _lib():
    fn = LIBRARIES.load("channel_pool").channel_pool_select
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = _I
    return fn


def _launch(x: torch.Tensor, with_index: bool):
    """(median, mode, index): two (B, H, W) planes and, with ``with_index``,
    the (2, B, H, W) uint8 channels they were taken from."""
    if x.dtype != torch.float32 or x.dim() != 4:
        raise ValueError(f"channel_pool: expected a float32 (B, C, H, W) tensor, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    b, c, h, w = x.shape
    med, mode = torch.empty((2, b, h, w), dtype=x.dtype, device=x.device).unbind(0)
    idx = torch.empty((2, b, h, w), dtype=torch.uint8, device=x.device) if with_index else None
    idx_ptrs = (idx[0].data_ptr(), idx[1].data_ptr()) if with_index else (None, None)
    args = (x.data_ptr(), med.data_ptr(), mode.data_ptr(), *idx_ptrs, b, c, h * w,
            torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        status = _lib()(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(x.device):
            status = _lib()(*args)
    check(status, "channel_pool_select")
    LAUNCHES.add()
    tracing.count_launch("channel_pool", x.device)
    return med, mode, idx


class _MedianMode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        med, mode, idx = _launch(x, True)
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return med, mode

    @staticmethod
    def backward(ctx, g_med, g_mode):
        (idx,) = ctx.saved_tensors
        idx = idx.long()
        grad = torch.zeros(ctx.shape, dtype=g_med.dtype, device=g_med.device)
        grad.scatter_add_(1, idx[0].unsqueeze(1), g_med.unsqueeze(1))
        grad.scatter_add_(1, idx[1].unsqueeze(1), g_mode.unsqueeze(1))
        return grad


def median_mode(x: torch.Tensor):
    """Per-pixel median and mode across the channels of a CUDA (B, C, H, W)
    float32 tensor: two (B, H, W) planes."""
    if not 1 <= x.shape[1] <= MAX_CHANNELS:
        raise ValueError(f"channel_pool: the kernel takes 1 to {MAX_CHANNELS} channels, got {x.shape[1]}")
    if torch.is_grad_enabled() and x.requires_grad:
        return _MedianMode.apply(x)
    med, mode, _ = _launch(x, False)
    return med, mode
