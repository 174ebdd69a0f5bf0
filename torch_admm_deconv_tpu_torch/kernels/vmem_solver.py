"""The whole-solve TV-ADMM kernels: K2 and K4 (fixed iteration count,
``csrc/vmem_solver.cu``) and K3 (residual-stopped, ``csrc/vmem_adaptive.cu``).

Counterpart of torch_admm_deconv_tpu/kernels/vmem_solver.py.

K2, ``admm_tv_vmem`` with ``schedule='batched'`` (JAX :918-1061, kernel
``_make_kernel`` :213-428)::

    s <- H^T y, u <- 0
    repeat maxit:  x = T((T s) * freq / (H W));  the K1 chain -> s, u
    return x       (zeros when maxit == 0)

K4, ``schedule='interleaved'`` (kernel ``_make_interleaved_kernel``
:134-210, here ``csrc/vmem_interleaved.cu``): the same math per plane with
the transform's left stage first; aniso and 'joint' only ('sample' runs K2,
as in JAX). One launch per solve: a thread-block cluster per plane, the
plane's state in the cluster's shared memory.

K3, ``admm_tv_adaptive_vmem`` (:724-915, kernel ``_make_adaptive_kernel``
:505-683): residual stopping, adaptive rho and the mixed-precision phase
per block (a plane, or a sample's C planes in 'sample' mode), optionally
returning the exit state for implicit differentiation.

T is the separable cas transform (no PSF or an axis-symmetric one) or the
2-D Hartley pair (any other real PSF), chosen by ``psf_is_axis_symmetric``.
Each solve is one C call on the caller's stream and one launch: K2 and K3
cooperative, K3 with its stopping test on the card, K4 clustered. On the
card the products run on the tensor cores: 'high' as 3xTF32 (float32
accuracy), the fast phase of 'mixed' as one bf16 pass on operands and
matrices rounded to bf16. The plain versions compute the same products
with ``torch.matmul`` in float32. A CUDA tensor launches the kernel; a CPU
tensor runs the plain version beside it. Forward-only, as the TPU kernels
are.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.kernels._build import LIBRARIES, LaunchCounter, check
from torch_admm_deconv_tpu_torch.kernels.fused_admm import FORWARD_ONLY, MODES, _ptr, check_planes
from torch_admm_deconv_tpu_torch.ops import fdops
from torch_admm_deconv_tpu_torch.ops.hartley import (
    cas_mats,
    cas_pair_mats,
    mirror_freq_full_joint,
    psf_is_axis_symmetric,
)
from torch_admm_deconv_tpu_torch.ops.prox import _EPS
from torch_admm_deconv_tpu_torch.ops.solver import AdaptiveResult, _elementwise_step, _htran
from torch_admm_deconv_tpu_torch.utils import tracing

LAUNCHES = LaunchCounter()  # K2
INTERLEAVED_LAUNCHES = LaunchCounter()  # K4
ADAPTIVE_LAUNCHES = LaunchCounter()  # K3

SCHEDULES = ("batched", "interleaved")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the C entry points' parameters, in order (csrc/vmem_solver.cu,
# csrc/vmem_interleaved.cu, csrc/vmem_adaptive.cu)
FIXED_ARGTYPES = [_VP] * 6 + [_I] + [_VP] * 12 + [_I] * 7 + [_VP]
INTERLEAVED_ARGTYPES = [_VP] * 6 + [_I] + [_VP] * 4 + [_I] * 7 + [_VP]
ADAPTIVE_ARGTYPES = [_VP] * 7 + [_I] + [_VP] * 11 + [_I] * 6 + [_F, _I, _F, _F, _I, _F, _I, _F, _VP]


def _fixed_lib():
    lib = LIBRARIES.load("vmem_solver")
    fn = lib.admm_tv_vmem_solve
    if fn.argtypes is None:
        fn.argtypes = FIXED_ARGTYPES
        fn.restype = _I
        lib.admm_tv_vmem_split_floats.argtypes = [_I] * 2
        lib.admm_tv_vmem_split_floats.restype = ctypes.c_long
    return lib, fn


def _interleaved_lib():
    lib = LIBRARIES.load("vmem_interleaved")
    fn = lib.admm_tv_vmem_interleaved
    if fn.argtypes is None:
        fn.argtypes = INTERLEAVED_ARGTYPES
        fn.restype = _I
        lib.admm_tv_vmem_interleaved_workspace.argtypes = [_I] * 4
        lib.admm_tv_vmem_interleaved_workspace.restype = ctypes.c_long
    return lib


def _adaptive_lib():
    lib = LIBRARIES.load("vmem_adaptive")
    fn = lib.admm_tv_adaptive_solve
    if fn.argtypes is None:
        fn.argtypes = ADAPTIVE_ARGTYPES
        fn.restype = _I
        lib.admm_tv_adaptive_workspace.argtypes = [_I] * 3
        lib.admm_tv_adaptive_workspace.restype = ctypes.c_long
    return lib


def vmem_solve_available(shape, dtype, kern, iso: bool, iso_mode: str) -> bool:
    """True when the whole-solve kernel takes this configuration (JAX
    vmem_solver.py:479-502): float32 NCHW, per-block shrinkage (aniso,
    'joint' or 'sample'; the batch-coupled 'compat' is not), and a PSF that
    is not being learned: one with ``requires_grad`` under grad mode takes
    the differentiable loop, as a traced kernel does in JAX. Any H and W:
    the TPU's tile and VMEM gates do not apply."""
    if dtype != torch.float32 or len(shape) != 4:
        return False
    if iso and iso_mode not in ("joint", "sample"):
        return False
    if kern is not None and kern.requires_grad and torch.is_grad_enabled():
        return False
    return True


def adaptive_vmem_available(shape, dtype, kern, iso: bool, iso_mode: str,
                            return_state: bool = False) -> bool:
    """Eligibility for :func:`admm_tv_adaptive_vmem` (JAX :686-699): the
    whole-solve gates. The TPU kernel's extra VMEM planes (z history, exit
    state) live in device memory here, so ``return_state`` changes
    nothing."""
    return vmem_solve_available(shape, dtype, kern, iso, iso_mode)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def _transform(v: torch.Tensor, mats: Sequence[torch.Tensor], fast: bool) -> torch.Tensor:
    """T(v) with K2's stage order (JAX vmem_solver.py:287-354): the cas
    transform's right stage first; the Hartley pair's left stages first, as
    in :func:`_xform`."""
    if len(mats) == 4:
        return _xform(v, mats, fast)
    r = _bf16 if fast else (lambda m: m)
    th, tw = (r(m) for m in mats)
    return th @ r(r(v) @ tw)


def _xform(v: torch.Tensor, mats: Sequence[torch.Tensor], fast: bool) -> torch.Tensor:
    """T(v) with K3's and K4's stage order, left stage first (JAX
    ``_make_xform``, vmem_solver.py:78-131)."""
    r = _bf16 if fast else (lambda m: m)
    if len(mats) == 2:
        th, tw = (r(m) for m in mats)
        return r(th @ r(v)) @ tw
    th, thp, cw, sw = (r(m) for m in mats)
    vb = r(v)
    return r(th @ vb) @ cw + r(thp @ vb) @ sw


def _fixed_plain(transform, hty, freq_full, mats, rho, tau, mode, maxit: int, fast_iters: int):
    s = hty
    u_x = u_y = x = torch.zeros_like(hty)
    for it in range(maxit):
        fast = it < fast_iters
        x = transform(transform(s, mats, fast) * freq_full, mats, fast)
        s, _, _, u_x, u_y = _elementwise_step(
            x, u_x, u_y, hty, rho, tau, mode is not None, mode or "joint"
        )
    return x


def admm_tv_vmem_plain(hty, freq_full, mats, rho, tau, mode, maxit: int, fast_iters: int):
    """K2's plain version: the same transforms with ``torch.matmul`` in
    float32 (bf16-rounded operands in the fast phase) and the K1 chain."""
    return _fixed_plain(_transform, hty, freq_full, mats, rho, tau, mode, maxit, fast_iters)


def admm_tv_vmem_interleaved_plain(hty, freq_full, mats, rho, tau, mode, maxit: int,
                                   fast_iters: int):
    """K4's plain version: K2's with the left-stage-first transform. The
    planes are independent in K4's modes, so the per-plane order of the TPU
    schedule needs no loop over planes."""
    return _fixed_plain(_xform, hty, freq_full, mats, rho, tau, mode, maxit, fast_iters)


def _launch(hty, freq_full, mats, rho_tau, mode, maxit, fast_iters):
    """K2. While the port records (``utils.tracing``), the solve adds the
    device nanoseconds of its stages (prologue, 4 product stages, chain) to
    the recorder's stage clock."""
    check_planes("admm_tv_vmem", hty)
    b, c, h, w = hty.shape
    if freq_full.shape != (h, w) or any(m.dtype != torch.float32 for m in mats):
        raise ValueError("admm_tv_vmem: spectrum or matrices do not match the planes")
    with tracing.span("solve.launch", kernel="k2"):
        general = len(mats) == 4
        out, s, ux0, ux1, uy0, uy1, y, a = (torch.empty_like(hty) for _ in range(8))
        d = torch.empty_like(hty) if general else None
        lib, fn = _fixed_lib()
        # the matrices' tf32 halves, split once per solve
        split = torch.empty(lib.admm_tv_vmem_split_floats(h, w), dtype=torch.float32,
                            device=hty.device)
        m = list(mats) + [None] * (4 - len(mats))
        group = c if mode == "sample" else 1
        stage_ns = tracing.launch_clock("k2", hty.device)
        with torch.cuda.device(hty.device):
            stream = torch.cuda.current_stream(hty.device).cuda_stream
            status = fn(
                hty.data_ptr(), freq_full.data_ptr(), *(_ptr(t) for t in m), len(mats),
                rho_tau.data_ptr(), out.data_ptr(), s.data_ptr(), ux0.data_ptr(), ux1.data_ptr(),
                uy0.data_ptr(), uy1.data_ptr(), y.data_ptr(), a.data_ptr(), _ptr(d),
                split.data_ptr(), _ptr(stage_ns), b * c, group, h, w, MODES[mode], maxit,
                fast_iters, stream,
            )
        check(status, "admm_tv_vmem_solve")
        LAUNCHES.add()
    return out


def _launch_interleaved(hty, freq_full, mats, rho_tau, mode, maxit, fast_iters, pack):
    """K4: one clustered launch per solve. ``pack`` (the TPU kernel's planes
    per grid program) is checked, not used: the kernel's unit is a plane.
    While the port records (``utils.tracing``), cluster 0 adds its device
    nanoseconds by stage (prologue, 4 product stages, chain), summed over
    its planes and iterations, to the recorder's stage clock."""
    check_planes("admm_tv_vmem", hty)
    b, c, h, w = hty.shape
    if freq_full.shape != (h, w) or any(m.dtype != torch.float32 for m in mats):
        raise ValueError("admm_tv_vmem: spectrum or matrices do not match the planes")
    with tracing.span("solve.launch", kernel="k4"):
        lib = _interleaved_lib()
        n_planes = b * c
        floats = lib.admm_tv_vmem_interleaved_workspace(n_planes, h, w, MODES[mode])
        check(0 if floats >= 0 else 1, "admm_tv_vmem_interleaved_workspace")
        out = torch.empty_like(hty)
        work = torch.empty(floats, dtype=torch.float32, device=hty.device)
        m = list(mats) + [None] * (4 - len(mats))
        stage_ns = tracing.launch_clock("k4", hty.device)
        with torch.cuda.device(hty.device):
            stream = torch.cuda.current_stream(hty.device).cuda_stream
            status = lib.admm_tv_vmem_interleaved(
                hty.data_ptr(), freq_full.data_ptr(), *(_ptr(t) for t in m), len(mats),
                rho_tau.data_ptr(), out.data_ptr(), work.data_ptr(), _ptr(stage_ns), n_planes,
                pack, h, w, MODES[mode], maxit, fast_iters, stream,
            )
        check(status, "admm_tv_vmem_interleaved")
        INTERLEAVED_LAUNCHES.add()
    return out


class _WholeSolve(torch.autograd.Function):
    """K2 (``pack`` None) or K4 (planes checked against groups of ``pack``)."""

    @staticmethod
    def forward(ctx, hty, freq_full, rho, tau, mode, maxit, fast_iters, pack, *mats):
        if hty.is_cuda:
            rho_tau = torch.stack([rho, tau]).to(torch.float32).contiguous()
            args = (hty.contiguous(), freq_full.contiguous(), [m.contiguous() for m in mats],
                    rho_tau, mode, maxit, fast_iters)
            if pack is None:
                return _launch(*args)
            return _launch_interleaved(*args, pack)
        plain = admm_tv_vmem_plain if pack is None else admm_tv_vmem_interleaved_plain
        return plain(hty, freq_full, mats, rho, tau, mode, maxit, fast_iters)

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


def _fixed_pack(shape, iso: bool, iso_mode: str, cap: int = 8) -> int:
    """Planes per group of the fixed-iteration solve (JAX :454-476): a
    sample's channels in 'sample' mode, else the largest divisor of B*C up
    to ``cap`` (the TPU's VMEM budget does not apply)."""
    b, c = shape[0], shape[1]
    if iso and iso_mode == "sample":
        return c
    total = b * c
    return max(g for g in range(1, min(cap, total) + 1) if total % g == 0)


def _transform_mats(h: int, w: int, kern, device):
    return cas_mats(h, w, device) if psf_is_axis_symmetric(kern) else cas_pair_mats(h, w, device)


def solve_inputs(xin: torch.Tensor, lmbd, rho, kern: Optional[torch.Tensor]):
    """(hty, freq_full, rho, tau, mats): everything the solve reads, built
    outside the kernel as the JAX wrapper builds it (vmem_solver.py:984-1005)."""
    with tracing.span("solve.inputs"):
        b, c, h, w = xin.shape
        dtype = xin.dtype
        rho = torch.as_tensor(rho, dtype=dtype, device=xin.device).reshape(())
        lmbd = torch.as_tensor(lmbd, dtype=dtype, device=xin.device).reshape(())
        # tau >= 0: the clip form of soft shrinkage needs it
        tau = torch.clamp_min(lmbd / rho, 0.0)
        # the inverse transform's 1/(H*W) is folded into the diagonal spectrum
        freq_c = fdops.freq_denominator((h, w), rho, kern, dtype, xin.device) * (1.0 / (h * w))
        freq_full = mirror_freq_full_joint(freq_c.expand(h, w // 2 + 1), w)
        mats = _transform_mats(h, w, kern, xin.device)
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
    schedule: str = "batched",
    device=None,
) -> torch.Tensor:
    """Whole-solve TV-ADMM; the same contract as ``ops.solver.admm_tv`` for
    the configurations :func:`vmem_solve_available` accepts (JAX
    vmem_solver.py:918-955). ``schedule``: 'batched' (K2) or 'interleaved'
    (K4, aniso and 'joint'; 'sample' runs K2, as in JAX). ``device``:
    ``None`` means CUDA; the CPU (the plain versions) only when named."""
    path = "k4" if schedule == "interleaved" and (not iso or iso_mode == "joint") else "k2"
    with tracing.span("solve", path=path, shape=np.shape(xin), maxit=maxit, precision=precision):
        if schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {schedule!r}")
        dev = resolve_device(device)
        xin = torch.as_tensor(xin, device=dev)
        kern = None if kern is None else torch.as_tensor(kern, device=dev)
        if xin.dim() != 4:
            raise ValueError(f"admm_tv_vmem expects (B, C, H, W), got {tuple(xin.shape)}")
        mode = iso_mode if iso else None
        if mode not in MODES:
            raise ValueError(
                f"whole solve supports aniso, 'sample' and 'joint', got {iso_mode!r}")
        fast_iters = fast_iterations(precision, fast_frac, maxit)
        hty, freq_full, rho, tau, mats = solve_inputs(xin, lmbd, rho, kern)
        interleaved = schedule == "interleaved" and mode in (None, "joint")
        pack = _fixed_pack(xin.shape, iso, iso_mode) if interleaved else None
        return _WholeSolve.apply(hty, freq_full, rho, tau, mode, maxit, fast_iters, pack, *mats)


# --- K3: the residual-stopped solve -----------------------------------------


class AdaptiveConfig(NamedTuple):
    """The static settings of one K3 solve (JAX :505-516, :850-864)."""

    g: int  # planes per block
    mode: Optional[str]  # None (aniso) | 'sample' | 'joint'
    maxit: int
    tol: float
    rho_mu: float
    rho_scale: float
    fast_switch: float
    fast_cap: int
    return_state: bool

    @property
    def adapt(self) -> bool:
        # rho_mu >= 1e29 turns residual balancing off as a Python branch, with
        # factor exactly 1: the runtime test r > rho_mu * s would still fire
        # at s == 0 (JAX :609-622)
        return self.rho_mu < 1e29

    @property
    def use_fast(self) -> bool:
        return self.fast_cap > 0 and self.fast_switch > self.tol


def adaptive_config(shape, iso: bool, iso_mode: str, maxit: int, tol: float, rho_mu: float,
                    rho_scale: float, precision: str, fast_switch, return_state: bool):
    mode = iso_mode if iso else None
    if mode not in MODES:
        raise ValueError(f"whole solve supports aniso, 'sample' and 'joint', got {iso_mode!r}")
    if precision == "mixed":
        switch = float(fast_switch) if fast_switch is not None else max(20.0 * tol, 1e-2)
        fast_cap = maxit - max(8, maxit // 8)
    elif precision == "high":
        switch, fast_cap = 0.0, 0
    else:
        raise ValueError(f"precision must be 'mixed' or 'high', got {precision!r}")
    g = shape[1] if mode == "sample" else 1
    return AdaptiveConfig(g, mode, int(maxit), float(tol), float(rho_mu), float(rho_scale),
                          switch, fast_cap, bool(return_state))


def adaptive_inputs(xin: torch.Tensor, lmbd, rho, kern: Optional[torch.Tensor], g: int):
    """(hty, habs2, d2, lmbd_rho0, mats) as the JAX wrapper builds them
    (:816-839): hty in blocks (n_blocks, g, H, W); |H|^2 and |D|^2 on the
    full grid by the conjugate mirror, pre-scaled by H*W so the rebuilt
    spectrum 1/(habs2 + rho d2) carries the inverse transform's 1/(H*W)."""
    with tracing.span("solve.inputs"):
        b, c, h, w = xin.shape
        dtype, dev = xin.dtype, xin.device
        lmbd = torch.as_tensor(lmbd, dtype=dtype, device=dev).reshape(())
        rho = torch.as_tensor(rho, dtype=dtype, device=dev).reshape(())
        d2 = fdops.grad_otf_abs2((h, w), dtype, dev)
        if kern is None or kern.numel() == 0:
            habs2 = torch.ones((h, w // 2 + 1), dtype=dtype, device=dev)
        else:
            otf = fdops.psf_otf(kern.to(dtype), (h, w))
            habs2 = (otf.real**2 + otf.imag**2).reshape(h, w // 2 + 1)
        hw = float(h * w)
        habs2_full = mirror_freq_full_joint(habs2, w) * hw
        d2_full = mirror_freq_full_joint(d2.expand(h, w // 2 + 1), w) * hw
        mats = _transform_mats(h, w, kern, dev)
        hty = _htran(xin, kern, (h, w), dtype).reshape(b * c // g, g, h, w)
        return hty, habs2_full, d2_full, torch.stack([lmbd, rho]), mats


def _schedule(k, r, sd, fast, cfg: AdaptiveConfig):
    """After an iteration (or at the start): leave the fast phase once its
    condition fails, resetting r and s to 1 (JAX :657-660), and decide which
    blocks run the next iteration. The kernel's ``schedule`` in
    csrc/vmem_adaptive.cu is the same test."""
    stay = fast & (k < cfg.fast_cap) & ((r > cfg.fast_switch) | (sd > cfg.fast_switch))
    leave = fast & ~stay
    r = torch.where(leave, torch.ones_like(r), r)
    sd = torch.where(leave, torch.ones_like(sd), sd)
    run = stay | ((k < cfg.maxit) & ((r > cfg.tol) | (sd > cfg.tol)))
    return run, stay, r, sd


def _shrink_blocks(ax, ay, tau, mode):
    """z = shrink(a, tau) with a per-block tau of shape (n_blocks, 1, 1, 1)
    (JAX :578-591)."""
    if mode is None:
        return ax - torch.minimum(torch.maximum(ax, -tau), tau), ay - torch.minimum(
            torch.maximum(ay, -tau), tau)
    if mode == "sample":
        nx = torch.sqrt(torch.sum(ax * ax, dim=1, keepdim=True) + _EPS)
        ny = torch.sqrt(torch.sum(ay * ay, dim=1, keepdim=True) + _EPS)
        return (torch.clamp_min(1.0 - tau / (nx + _EPS), 0.0) * ax,
                torch.clamp_min(1.0 - tau / (ny + _EPS), 0.0) * ay)
    mag = torch.sqrt(ax * ax + ay * ay + _EPS)
    sc = torch.clamp_min(1.0 - tau / mag, 0.0)
    return sc * ax, sc * ay


def _adjoint_sum(tx, ty):
    """Dx^T tx + Dy^T ty, summed in the TPU kernel's order."""
    return tx - torch.roll(tx, -1, dims=-1) + ty - torch.roll(ty, -1, dims=-2)


def admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lmbd_rho0, cfg: AdaptiveConfig):
    """K3's plain version, all blocks at once: each iteration computes every
    block and keeps the new values only where the block runs
    (``torch.where`` on per-block masks); ``torch.matmul`` transforms, left
    stage first. Returns (x, z_x, z_y, u_x, u_y, iters, r, s, rho) with the
    planes in blocks (n_blocks, g, H, W) and per-block vectors."""
    nb, _, h, w = hty.shape
    dev = hty.device
    lmbd, rho0 = lmbd_rho0[0], lmbd_rho0[1]
    scale = torch.sqrt(torch.tensor(float(2 * cfg.g * h * w), dtype=torch.float32, device=dev))
    x, zx, zy, ux, uy = (torch.zeros_like(hty) for _ in range(5))
    s = hty
    k = torch.zeros(nb, dtype=torch.int32, device=dev)
    r = torch.ones(nb, dtype=torch.float32, device=dev)
    sd = torch.ones_like(r)
    rho = rho0.to(torch.float32).expand(nb).clone()
    fast = torch.full((nb,), cfg.use_fast, dtype=torch.bool, device=dev)
    run, fast, r, sd = _schedule(k, r, sd, fast, cfg)

    def blk(v):
        return v.reshape(nb, 1, 1, 1)

    def xform(v):
        if not bool(fast.any()):
            return _xform(v, mats, False)
        if bool(fast.all()):
            return _xform(v, mats, True)
        return torch.where(blk(fast), _xform(v, mats, True), _xform(v, mats, False))

    one = torch.ones_like(r)
    for _ in range(cfg.maxit):
        if not bool(run.any()):
            break
        rb = blk(rho)
        xn = xform(xform(s) * (1.0 / (habs2 + rb * d2)))
        dxk, dyk = fdops.dx(xn), fdops.dy(xn)
        ax, ay = dxk + ux, dyk + uy
        zxn, zyn = _shrink_blocks(ax, ay, torch.clamp_min(lmbd / rb, 0.0), cfg.mode)
        unx, uny = ax - zxn, ay - zyn
        rx, ry = dxk - zxn, dyk - zyn
        r_new = torch.sqrt(torch.sum(rx * rx, dim=(1, 2, 3)) + torch.sum(ry * ry, dim=(1, 2, 3))) / scale
        sdual = rb * _adjoint_sum(zxn - zx, zyn - zy)
        sd_new = torch.sqrt(torch.sum(sdual * sdual, dim=(1, 2, 3))) / scale
        if cfg.adapt:
            factor = torch.where(
                r_new > cfg.rho_mu * sd_new, one * cfg.rho_scale,
                torch.where(sd_new > cfg.rho_mu * r_new, one * (1.0 / cfg.rho_scale), one))
        else:
            factor = one
        rho_new = rho * factor
        inv_f = blk(1.0 / factor)
        uxs, uys = unx * inv_f, uny * inv_f
        s_new = hty + blk(rho_new) * _adjoint_sum(zxn - uxs, zyn - uys)
        m = blk(run)
        x, s = torch.where(m, xn, x), torch.where(m, s_new, s)
        zx, zy = torch.where(m, zxn, zx), torch.where(m, zyn, zy)
        ux, uy = torch.where(m, uxs, ux), torch.where(m, uys, uy)
        k = k + run.to(torch.int32)
        r, sd = torch.where(run, r_new, r), torch.where(run, sd_new, sd)
        rho = torch.where(run, rho_new, rho)
        nxt, stay, r2, sd2 = _schedule(k, r, sd, fast, cfg)
        fast = torch.where(run, stay, fast)
        r, sd = torch.where(run, r2, r), torch.where(run, sd2, sd)
        run = run & nxt
    return x, zx, zy, ux, uy, k, r, sd, rho


def _launch_adaptive(hty, habs2, d2, mats, lmbd_rho0, cfg: AdaptiveConfig):
    """K3. While the port records (``utils.tracing``), the solve adds the
    device nanoseconds of its stages (prologue, 4 product stages, residual,
    finalize, right-hand side) to the recorder's stage clock."""
    check_planes("admm_tv_adaptive_vmem", hty)
    nb, g, h, w = hty.shape
    n_planes = nb * g
    if habs2.shape != (h, w) or d2.shape != (h, w) or any(m.dtype != torch.float32 for m in mats):
        raise ValueError("admm_tv_adaptive_vmem: spectra or matrices do not match the planes")
    with tracing.span("solve.launch", kernel="k3"):
        lib = _adaptive_lib()
        dev = hty.device
        x, zx, zy, ux, uy = (torch.empty_like(hty) for _ in range(5))
        work = torch.empty(lib.admm_tv_adaptive_workspace(n_planes, h, w), dtype=torch.float32,
                           device=dev)
        state = torch.empty(2 * nb * 8, dtype=torch.int32, device=dev)  # 2 x n_blocks BlockStates
        iters = torch.empty(nb, dtype=torch.int32, device=dev)
        stats = torch.empty(3, nb, dtype=torch.float32, device=dev)
        m = list(mats) + [None] * (4 - len(mats))
        scale = float(np.sqrt(np.float32(2 * g * h * w)))
        stage_ns = tracing.launch_clock("k3", dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            status = lib.admm_tv_adaptive_solve(
                hty.data_ptr(), habs2.data_ptr(), d2.data_ptr(), *(_ptr(t) for t in m), len(mats),
                lmbd_rho0.data_ptr(), x.data_ptr(), zx.data_ptr(), zy.data_ptr(), ux.data_ptr(),
                uy.data_ptr(), work.data_ptr(), state.data_ptr(), iters.data_ptr(),
                stats.data_ptr(), _ptr(stage_ns), n_planes, g, h, w, MODES[cfg.mode], cfg.maxit,
                cfg.tol, int(cfg.adapt), cfg.rho_mu, cfg.rho_scale, int(cfg.use_fast),
                cfg.fast_switch, cfg.fast_cap, scale, stream,
            )
        check(status, "admm_tv_adaptive_solve")
        ADAPTIVE_LAUNCHES.add()
    return (x, zx, zy, ux, uy, iters, *stats.unbind(0))


class _AdaptiveSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hty, habs2, d2, lmbd_rho0, cfg, *mats):
        if hty.is_cuda:
            return _launch_adaptive(
                hty.contiguous(), habs2.contiguous(), d2.contiguous(),
                [mm.contiguous() for mm in mats], lmbd_rho0.to(torch.float32).contiguous(), cfg,
            )
        return admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lmbd_rho0, cfg)

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError(FORWARD_ONLY)


def admm_tv_adaptive_vmem(
    xin,
    lmbd,
    rho,
    kern=None,
    iso: bool = False,
    maxit: int = 500,
    *,
    tol: float = 1e-4,
    iso_mode: str = "sample",
    rho_mu: float = 10.0,
    rho_scale: float = 2.0,
    precision: str = "mixed",
    fast_switch: Optional[float] = None,
    return_state: bool = False,
    device=None,
):
    """Whole-solve TV-ADMM with residual stopping and adaptive rho per
    block (JAX vmem_solver.py:724-915): each plane, or each sample in
    'sample' mode, stops as soon as its own scaled residuals reach ``tol``.

    ``precision='mixed'`` (default) runs single-pass bf16 transforms while
    a residual sits above ``fast_switch`` (default ``max(20 tol, 1e-2)``)
    and fewer than ``maxit - max(8, maxit // 8)`` iterations have run, then
    float32; the exit residuals always come from float32 iterations.

    Returns an ``AdaptiveResult`` whose ``iters`` (int32), ``r_norm``,
    ``s_norm`` and ``rho`` (float32) have shape (n_blocks,); with
    ``return_state`` ``(AdaptiveResult, (x, z_x, z_y, u_x, u_y))``, the
    ADMM state at exit. ``device``: ``None`` means CUDA; the CPU (the plain
    version) only when named."""
    with tracing.span("solve", path="k3", shape=np.shape(xin), maxit=maxit, precision=precision):
        dev = resolve_device(device)
        xin = torch.as_tensor(xin, device=dev)
        kern = None if kern is None else torch.as_tensor(kern, device=dev)
        if xin.dim() != 4:
            raise ValueError(
                f"admm_tv_adaptive_vmem expects (B, C, H, W), got {tuple(xin.shape)}")
        cfg = adaptive_config(xin.shape, iso, iso_mode, maxit, tol, rho_mu, rho_scale, precision,
                              fast_switch, return_state)
        hty, habs2, d2, lmbd_rho0, mats = adaptive_inputs(xin, lmbd, rho, kern, cfg.g)
        x, zx, zy, ux, uy, iters, r, sd, rho_f = _AdaptiveSolve.apply(hty, habs2, d2, lmbd_rho0,
                                                                      cfg, *mats)
        shape = xin.shape
        result = AdaptiveResult(x=x.reshape(shape), iters=iters, r_norm=r, s_norm=sd, rho=rho_f)
        if return_state:
            return result, tuple(t.reshape(shape) for t in (x, zx, zy, ux, uy))
        return result
