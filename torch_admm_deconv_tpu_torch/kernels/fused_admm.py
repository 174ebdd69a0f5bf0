"""K1: one fused pass of the ADMM elementwise chain (CUDA, ``csrc/fused_admm.cu``).

Counterpart of torch_admm_deconv_tpu/kernels/fused_admm.py (:42-159). Per
solver iteration, everything between the inverse and the next forward FFT
is elementwise plus one-pixel circular shifts:

    a  = D x + u;   z = shrink(a, tau);   u' = a - z
    s' = H^T y + rho * (Dx^T(z_x - u'_x) + Dy^T(z_y - u'_y))

The kernel does it in one pass: 4 reads (x, u_x, u_y, hty) and 3 writes
(s, u'_x, u'_y). Any float32 NCHW shape is accepted. A CUDA tensor launches
the kernel; a CPU tensor runs the plain version,
:func:`torch_admm_deconv_tpu_torch.ops.solver._elementwise_step`. The
kernel is forward-only, as the TPU kernel is.
"""

from __future__ import annotations

import ctypes

import torch

from torch_admm_deconv_tpu_torch.kernels._build import LIBRARIES, LaunchCounter, check
from torch_admm_deconv_tpu_torch.ops.solver import _elementwise_step

LAUNCHES = LaunchCounter()
MODES = {None: 0, "sample": 1, "joint": 2}
FORWARD_ONLY = (
    "use_pallas=True is inference-only: the hand-written ADMM kernels have no "
    "backward (as in the JAX package, models/denoiser.py:120-122); train with "
    "use_pallas=False"
)

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = LIBRARIES.load("fused_admm")
    fn = lib.fused_admm_step
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 8 + [_I] * 5 + [_VP]
        fn.restype = _I
    return fn


def check_planes(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 4-D tensor of one
    shape on one CUDA device."""
    ref = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32 or t.dim() != 4 or not t.is_cuda:
            raise ValueError(f"{name}: expected float32 (B, C, H, W) CUDA tensors, got {t.dtype} {tuple(t.shape)} on {t.device}")
        if t.shape != ref.shape or t.device != ref.device:
            raise ValueError(f"{name}: tensors differ in shape or device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _launch(x, u_x, u_y, hty, rho_tau, mode):
    check_planes("fused_elementwise_step", x, u_x, u_y, hty)
    b, c, h, w = x.shape
    g = c if mode == "sample" else 1
    s, uxo, uyo = (torch.empty_like(x) for _ in range(3))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = _lib()(
            x.data_ptr(), u_x.data_ptr(), u_y.data_ptr(), hty.data_ptr(), rho_tau.data_ptr(),
            s.data_ptr(), uxo.data_ptr(), uyo.data_ptr(), b * c, g, h, w, MODES[mode], stream,
        )
    check(status, "fused_admm_step")
    LAUNCHES.add()
    return s, uxo, uyo


class _FusedStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u_x, u_y, hty, rho, tau, mode):
        if x.is_cuda:
            rho_tau = torch.stack([rho, tau]).to(torch.float32).contiguous()
            return _launch(
                x.contiguous(), u_x.contiguous(), u_y.contiguous(), hty.contiguous(), rho_tau, mode
            )
        s, _, _, uxo, uyo = _elementwise_step(
            x, u_x, u_y, hty, rho, tau, mode is not None, mode or "joint"
        )
        return s, uxo, uyo

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(FORWARD_ONLY)


def fused_elementwise_step(x, u_x, u_y, hty, rho, tau, iso, iso_mode):
    """Drop-in for ``ops.solver._elementwise_step`` (z outputs elided); JAX
    fused_admm.py:120-159. tau is clamped to >= 0, which the clip form of
    the shrinkage needs; 'compat' is rejected (its norm couples the batch)."""
    mode = iso_mode if iso else None
    if mode == "compat":
        raise ValueError("fused step does not support the batch-coupled compat iso mode")
    if mode not in MODES:
        raise ValueError(f"unknown iso_mode: {iso_mode!r}")
    rho = torch.as_tensor(rho, dtype=x.dtype, device=x.device).reshape(())
    tau = torch.clamp_min(torch.as_tensor(tau, dtype=x.dtype, device=x.device).reshape(()), 0.0)
    s, uxo, uyo = _FusedStep.apply(x, u_x, u_y, hty, rho, tau, mode)
    return s, None, None, uxo, uyo
