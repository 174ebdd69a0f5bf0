"""K2: the whole fixed-iteration TV-ADMM solve (CUDA, ``csrc/vmem_solver.cu``).

Counterpart of torch_admm_deconv_tpu/kernels/vmem_solver.py
(``admm_tv_vmem`` :918-1061, kernel ``_make_kernel`` :213-428):

    s <- H^T y, u <- 0
    repeat maxit:  x = T((T s) * freq / (H W));  the K1 chain -> s, u
    return x       (zeros when maxit == 0)

T is the separable cas transform (no PSF or an axis-symmetric one) or the
2-D Hartley pair (any other real PSF), chosen by ``psf_is_axis_symmetric``.
One C call runs the whole solve on the caller's stream. 'high' precision is
float32 throughout; 'mixed' rounds every stage operand and matrix to bf16
for the first ``fast_frac * maxit`` iterations. A CUDA tensor launches the
kernel; a CPU tensor runs :func:`admm_tv_vmem_plain`. Forward-only, as the
TPU kernel is.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.kernels._build import LIBRARIES, LaunchCounter, check
from torch_admm_deconv_tpu_torch.kernels.fused_admm import FORWARD_ONLY, MODES, check_planes
from torch_admm_deconv_tpu_torch.ops import fdops
from torch_admm_deconv_tpu_torch.ops.hartley import (
    cas_mats,
    cas_pair_mats,
    mirror_freq_full_joint,
    psf_is_axis_symmetric,
)
from torch_admm_deconv_tpu_torch.ops.solver import _elementwise_step, _htran

LAUNCHES = LaunchCounter()

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = LIBRARIES.load("vmem_solver").admm_tv_vmem_solve
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 6 + [_I] + [_VP] * 10 + [_I] * 7 + [_VP]
        fn.restype = _I
    return fn


def vmem_solve_available(shape, dtype, kern, iso: bool, iso_mode: str) -> bool:
    """True when the whole-solve kernel takes this configuration (JAX
    vmem_solver.py:479-502): float32 NCHW, per-block shrinkage (aniso,
    'joint' or 'sample'; the batch-coupled 'compat' is not), and a PSF that
    is not being learned: one with ``requires_grad`` under grad mode takes
    the differentiable loop, as a traced kernel does in JAX. Any H and W."""
    if dtype != torch.float32 or len(shape) != 4:
        return False
    if iso and iso_mode not in ("joint", "sample"):
        return False
    if kern is not None and kern.requires_grad and torch.is_grad_enabled():
        return False
    return True


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def _transform(v: torch.Tensor, mats: Sequence[torch.Tensor], fast: bool) -> torch.Tensor:
    """T(v) with the kernel's stage order (JAX vmem_solver.py:287-354)."""
    r = _bf16 if fast else (lambda m: m)
    if len(mats) == 2:
        th, tw = (r(m) for m in mats)
        return th @ r(r(v) @ tw)
    th, thp, cw, sw = (r(m) for m in mats)
    vb = r(v)
    return r(th @ vb) @ cw + r(thp @ vb) @ sw


def admm_tv_vmem_plain(hty, freq_full, mats, rho, tau, mode, maxit: int, fast_iters: int):
    """K2's plain version: the same transforms with ``torch.matmul`` in
    float32 (bf16-rounded operands in the fast phase) and the K1 chain."""
    s = hty
    u_x = u_y = x = torch.zeros_like(hty)
    for it in range(maxit):
        fast = it < fast_iters
        x = _transform(_transform(s, mats, fast) * freq_full, mats, fast)
        s, _, _, u_x, u_y = _elementwise_step(
            x, u_x, u_y, hty, rho, tau, mode is not None, mode or "joint"
        )
    return x


def _launch(hty, freq_full, mats, rho_tau, mode, maxit, fast_iters):
    check_planes("admm_tv_vmem", hty)
    b, c, h, w = hty.shape
    if freq_full.shape != (h, w) or any(m.dtype != torch.float32 for m in mats):
        raise ValueError("admm_tv_vmem: spectrum or matrices do not match the planes")
    general = len(mats) == 4
    out, s, ux0, ux1, uy0, uy1, y, a = (torch.empty_like(hty) for _ in range(8))
    d = torch.empty_like(hty) if general else None
    m = list(mats) + [None] * (4 - len(mats))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(hty.device):
        stream = torch.cuda.current_stream(hty.device).cuda_stream
        status = _lib()(
            hty.data_ptr(), freq_full.data_ptr(), *(ptr(t) for t in m), len(mats),
            rho_tau.data_ptr(), out.data_ptr(), s.data_ptr(), ux0.data_ptr(), ux1.data_ptr(),
            uy0.data_ptr(), uy1.data_ptr(), y.data_ptr(), a.data_ptr(), ptr(d),
            b * c, c if mode == "sample" else 1, h, w, MODES[mode], maxit, fast_iters, stream,
        )
    check(status, "admm_tv_vmem_solve")
    LAUNCHES.add()
    return out


class _WholeSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hty, freq_full, rho, tau, mode, maxit, fast_iters, *mats):
        if hty.is_cuda:
            rho_tau = torch.stack([rho, tau]).to(torch.float32).contiguous()
            return _launch(
                hty.contiguous(), freq_full.contiguous(), [m.contiguous() for m in mats],
                rho_tau, mode, maxit, fast_iters,
            )
        return admm_tv_vmem_plain(hty, freq_full, mats, rho, tau, mode, maxit, fast_iters)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(FORWARD_ONLY)


def fast_iterations(precision: str, fast_frac: float, maxit: int) -> int:
    """Iterations of the single-pass bf16 phase (JAX vmem_solver.py:1021-1028)."""
    if precision == "mixed":
        return max(0, min(int(fast_frac * maxit), maxit))
    if precision == "high":
        return 0
    raise ValueError(f"precision must be 'mixed' or 'high', got {precision!r}")


def solve_inputs(xin: torch.Tensor, lmbd, rho, kern: Optional[torch.Tensor]):
    """(hty, freq_full, rho, tau, mats): everything the solve reads, built
    outside the kernel as the JAX wrapper builds it (vmem_solver.py:984-1005)."""
    b, c, h, w = xin.shape
    dtype = xin.dtype
    rho = torch.as_tensor(rho, dtype=dtype, device=xin.device).reshape(())
    lmbd = torch.as_tensor(lmbd, dtype=dtype, device=xin.device).reshape(())
    # tau >= 0: the clip form of soft shrinkage needs it
    tau = torch.clamp_min(lmbd / rho, 0.0)
    # the inverse transform's 1/(H*W) is folded into the diagonal spectrum
    freq_c = fdops.freq_denominator((h, w), rho, kern, dtype, xin.device) * (1.0 / (h * w))
    freq_full = mirror_freq_full_joint(freq_c.expand(h, w // 2 + 1), w)
    if psf_is_axis_symmetric(kern):
        mats = cas_mats(h, w, xin.device)
    else:
        mats = cas_pair_mats(h, w, xin.device)
    hty = _htran(xin, kern, (h, w), dtype)
    return hty, freq_full, rho, tau, mats


def admm_tv_vmem(
    xin,
    lmbd,
    rho,
    kern=None,
    iso: bool = False,
    maxit: int = 100,
    *,
    iso_mode: str = "joint",
    precision: str = "high",
    fast_frac: float = 0.75,
    device=None,
) -> torch.Tensor:
    """Whole-solve TV-ADMM; the same contract as ``ops.solver.admm_tv`` for
    the configurations :func:`vmem_solve_available` accepts (JAX
    vmem_solver.py:918-955). ``schedule='interleaved'`` is not ported.
    ``device``: ``None`` means CUDA; the CPU (the plain version) only when
    named."""
    dev = resolve_device(device)
    xin = torch.as_tensor(xin, device=dev)
    kern = None if kern is None else torch.as_tensor(kern, device=dev)
    if xin.dim() != 4:
        raise ValueError(f"admm_tv_vmem expects (B, C, H, W), got {tuple(xin.shape)}")
    mode = iso_mode if iso else None
    if mode not in MODES:
        raise ValueError(f"whole solve supports aniso, 'sample' and 'joint', got {iso_mode!r}")
    fast_iters = fast_iterations(precision, fast_frac, maxit)
    hty, freq_full, rho, tau, mats = solve_inputs(xin, lmbd, rho, kern)
    return _WholeSolve.apply(hty, freq_full, rho, tau, mode, maxit, fast_iters, *mats)
