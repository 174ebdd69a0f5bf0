"""K1: one fused pass of the ADMM elementwise chain (CUDA, ``csrc/fused_admm.cu``).

Counterpart of torch_admm_deconv_tpu/kernels/fused_admm.py (:42-159). Per
solver iteration, everything between the inverse and the next forward FFT
is elementwise plus one-pixel circular shifts:

    a  = D x + u;   z = shrink(a, tau);   u' = a - z
    s' = H^T y + rho * (Dx^T(z_x - u'_x) + Dy^T(z_y - u'_y))

The kernel does it in one pass over tiles with their halo staged in shared
memory: 4 reads (x, u_x, u_y, hty) and 3 writes (s, u'_x, u'_y). Any
float32 NCHW shape is accepted. A CUDA tensor launches
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
_F = ctypes.c_float
# fused_admm_step(x, ux, uy, hty, rho_p, tau_p, rho_v, tau_v, s, uxo, uyo,
# n_planes, g, h, w, mode, stream)
ARGTYPES = [_VP] * 6 + [_F] * 2 + [_VP] * 3 + [_I] * 5 + [_VP]


def _lib():
    lib = LIBRARIES.load("fused_admm")
    fn = lib.fused_admm_step
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
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


def _scalar(v, like: torch.Tensor):
    """(tensor, value) of rho or tau: a one-element tensor becomes a float32
    tensor on the planes' device, read there by the kernel (no host sync); a
    number passes by value. The caller holds the tensor until the kernel is
    launched: a converted copy freed earlier could be handed to the other
    scalar's copy by the caching allocator."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1:
            raise ValueError(f"fused_elementwise_step: rho and tau must be scalars, got shape {tuple(v.shape)}")
        return v.to(device=like.device, dtype=torch.float32), 0.0
    return None, float(v)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(x, u_x, u_y, hty, rho, tau, mode):
    """One launch; rho and tau are numbers or tensors (tau is clamped to
    >= 0 in the kernel). The three outputs share one allocation."""
    x, u_x, u_y, hty = (t.contiguous() for t in (x, u_x, u_y, hty))
    check_planes("fused_elementwise_step", x, u_x, u_y, hty)
    b, c, h, w = x.shape
    g = c if mode == "sample" else 1
    out = torch.empty((3, b, c, h, w), dtype=x.dtype, device=x.device)
    s, uxo, uyo = out.unbind(0)
    rho_t, rho_v = _scalar(rho, x)
    tau_t, tau_v = _scalar(tau, x)
    args = (x.data_ptr(), u_x.data_ptr(), u_y.data_ptr(), hty.data_ptr(), _ptr(rho_t),
            _ptr(tau_t), rho_v, tau_v, s.data_ptr(), uxo.data_ptr(), uyo.data_ptr(), b * c, g, h,
            w, MODES[mode], torch.cuda.current_stream(x.device).cuda_stream)
    if x.device.index == torch.cuda.current_device():
        status = _lib()(*args)
    else:  # the launch goes to the current device's context
        with torch.cuda.device(x.device):
            status = _lib()(*args)
    check(status, "fused_admm_step")
    LAUNCHES.add()
    return s, uxo, uyo


class _FusedStep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, u_x, u_y, hty, rho, tau, mode):
        if x.is_cuda:
            return _launch(x, u_x, u_y, hty, rho, tau, mode)
        s, _, _, uxo, uyo = _elementwise_step(
            x, u_x, u_y, hty, rho, tau, mode is not None, mode or "joint"
        )
        return s, uxo, uyo

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(FORWARD_ONLY)


def _needs_graph(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def fused_elementwise_step(x, u_x, u_y, hty, rho, tau, iso, iso_mode):
    """Drop-in for ``ops.solver._elementwise_step`` (z outputs elided); JAX
    fused_admm.py:120-159. tau is clamped to >= 0, which the clip form of
    the shrinkage needs; 'compat' is rejected (its norm couples the batch).
    A CUDA call outside autograd launches the kernel directly: numbers pass
    by value, and only a tensor rho or tau that is not float32 on the
    planes' device is copied there; with autograd it goes through a
    forward-only Function, whose backward raises."""
    mode = iso_mode if iso else None
    if mode == "compat":
        raise ValueError("fused step does not support the batch-coupled compat iso mode")
    if mode not in MODES:
        raise ValueError(f"unknown iso_mode: {iso_mode!r}")
    if x.is_cuda and not _needs_graph(x, u_x, u_y, hty, rho, tau):
        s, uxo, uyo = _launch(x, u_x, u_y, hty, rho, tau, mode)
        return s, None, None, uxo, uyo
    rho = torch.as_tensor(rho, dtype=x.dtype, device=x.device).reshape(())
    tau = torch.clamp_min(torch.as_tensor(tau, dtype=x.dtype, device=x.device).reshape(()), 0.0)
    s, uxo, uyo = _FusedStep.apply(x, u_x, u_y, hty, rho, tau, mode)
    return s, None, None, uxo, uyo
