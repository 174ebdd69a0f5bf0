"""Batched FFT-based TV-regularized ADMM deconvolution: the solver core.

Counterpart of torch_admm_deconv_tpu/ops/solver.py (:47-446). Each
iteration is one x-update (``torch.fft.rfft2`` / ``irfft2`` with the real
frequency diagonal) and one elementwise pass that fuses the shrinkage, the
dual update and the next x-update right-hand side; H^T y is hoisted out of
the loop. ``admm_tv`` keeps the JAX dispatch: with ``use_pallas`` and not
``remat`` an eligible solve runs whole in the K2 kernel
(kernels/vmem_solver.py), otherwise the loop below runs, with the K1 kernel
(kernels/fused_admm.py) as its elementwise step when ``use_pallas`` is set
and the mode is not 'compat'. ``admm_tv_adaptive`` is the classical solve
with residual stopping and adaptive rho (one global stopping decision, the
same ``torch.fft`` loop), and ``tv_objective`` the diagnostic objective.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.ops import fdops
from torch_admm_deconv_tpu_torch.ops.prox import block_thresh, block_thresh_joint, soft_thresh

FFT_IMPLS = ("auto", "xla", "dht", "mxu")


class ADMMState(NamedTuple):
    """Carried state of one ADMM instance batch (JAX solver.py:47-53)."""

    x: torch.Tensor  # current primal estimate (B, C, H, W)
    s: torch.Tensor  # right-hand side of the next x-update (spatial domain)
    u_x: torch.Tensor  # scaled dual for the x-gradient split
    u_y: torch.Tensor  # scaled dual for the y-gradient split


def _shrink(dxu, dyu, tau, iso: bool, iso_mode: str):
    """JAX solver.py:56-66."""
    if not iso:
        return soft_thresh(dxu, tau), soft_thresh(dyu, tau)
    if iso_mode == "compat":
        # reference behaviour: independent x/y shrinkage, norm over (B, C)
        return block_thresh(dxu, tau, axis=(0, 1)), block_thresh(dyu, tau, axis=(0, 1))
    if iso_mode == "sample":
        return block_thresh(dxu, tau, axis=(1,)), block_thresh(dyu, tau, axis=(1,))
    if iso_mode == "joint":
        return block_thresh_joint(dxu, dyu, tau)
    raise ValueError(f"unknown iso_mode: {iso_mode!r}")


def _x_update(s: torch.Tensor, freq_c: torch.Tensor, im_shape: Tuple[int, int]) -> torch.Tensor:
    """x = irfft2(freq_c * rfft2(s)), the circulant diagonal solve
    (JAX solver.py:69-71)."""
    return torch.fft.irfft2(freq_c * torch.fft.rfft2(s), s=im_shape)


def _htran(xin, kern, im_shape, dtype):
    """Loop-invariant H^T x_in in the frequency domain (JAX solver.py:112-122)."""
    if kern is None or kern.numel() == 0:
        return xin
    otf_c = fdops.psf_otf_centered(kern.to(dtype), im_shape)
    return fdops.htran_fft(xin, otf_c, im_shape)


def _elementwise_step(x, u_x, u_y, hty, rho, tau, iso, iso_mode):
    """Post-FFT half of iteration k fused with the pre-FFT half of k+1:
    shrinkage, dual update and ``s' = H^T y + rho (Dx^T(z_x - u_x') +
    Dy^T(z_y - u_y'))`` (JAX solver.py:125-140). Also the plain version of
    the K1 kernel (kernels/fused_admm.py)."""
    dxk = fdops.dx(x)
    dyk = fdops.dy(x)
    z_x, z_y = _shrink(dxk + u_x, dyk + u_y, tau, iso, iso_mode)
    u_x = u_x + dxk - z_x
    u_y = u_y + dyk - z_y
    s = hty + rho * (fdops.dx_t(z_x - u_x) + fdops.dy_t(z_y - u_y))
    return s, z_x, z_y, u_x, u_y


def _as_scalar(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(())


def admm_tv(
    xin,
    lmbd,
    rho,
    kern=None,
    iso: bool = False,
    maxit: int = 100,
    *,
    iso_mode: str = "compat",
    remat: bool = False,
    use_pallas: bool = False,
    fft_impl: str = "auto",
    precision: str = "high",
    fast_frac: float = 0.75,
    device=None,
) -> torch.Tensor:
    """Fixed-iteration TV-ADMM (JAX solver.py:152-231).

    Args:
      xin: (B, C, H, W) blurred/noisy batch (also (C, H, W) / (H, W)).
      lmbd, rho: TV weight and penalty, numbers or tensors (learnable).
      kern: (1, 1, kh, kw) PSF, or None/empty for pure TV denoising.
      iso: isotropic (block) vs anisotropic (soft) shrinkage.
      maxit: fixed iteration count.
      iso_mode: 'compat' | 'sample' | 'joint'.
      remat: recompute each iteration in the backward pass
        (``torch.utils.checkpoint``) when a gradient is taken.
      use_pallas: route through the hand-written kernels (forward only).
      fft_impl: accepted for API parity; every value runs ``torch.fft``.
      precision, fast_frac: 'high' | 'mixed' schedule of the whole-solve
        kernel; ignored on the loop path.
      device: ``None`` means CUDA; the CPU only when named.

    Returns the restored batch, same shape as ``xin``.
    """
    if fft_impl not in FFT_IMPLS:
        raise ValueError(f"unknown fft_impl: {fft_impl!r}")
    dev = resolve_device(device)
    xin = torch.as_tensor(xin, device=dev)
    kern = None if kern is None else torch.as_tensor(kern, device=dev)
    eff_mode = whole_solve_mode(xin.shape, xin.dtype, kern, iso, iso_mode, use_pallas, remat)
    if eff_mode is not None:
        from torch_admm_deconv_tpu_torch.kernels.vmem_solver import admm_tv_vmem

        shape = (1,) * (4 - xin.ndim) + tuple(xin.shape)
        out = admm_tv_vmem(
            xin.reshape(shape), lmbd, rho, kern, iso, maxit, iso_mode=eff_mode,
            precision=precision, fast_frac=fast_frac, device=dev,
        )
        return out.reshape(xin.shape)
    return _admm_tv_scan(
        xin, lmbd, rho, kern, iso=iso, maxit=maxit, iso_mode=iso_mode,
        remat=remat, use_pallas=use_pallas,
    )


def whole_solve_mode(shape, dtype, kern, iso: bool, iso_mode: str = "compat",
                     use_pallas: bool = True, remat: bool = False) -> Optional[str]:
    """The iso mode in which :func:`admm_tv` runs a call of this shape on the
    whole-solve kernel (K2), or None when the call takes the loop. At batch
    1 'compat' runs as 'sample': the batch+channel-coupled norm over one
    sample is exactly the channel-coupled one (JAX solver.py:208-212)."""
    if not use_pallas or remat:
        return None
    from torch_admm_deconv_tpu_torch.kernels.vmem_solver import vmem_solve_available

    shape = (1,) * (4 - len(shape)) + tuple(shape)
    eff_mode = "sample" if iso and iso_mode == "compat" and shape[0] == 1 else iso_mode
    return eff_mode if vmem_solve_available(shape, dtype, kern, iso, eff_mode) else None


def _admm_tv_scan(
    xin: torch.Tensor,
    lmbd,
    rho,
    kern: Optional[torch.Tensor] = None,
    iso: bool = False,
    maxit: int = 100,
    *,
    iso_mode: str = "compat",
    remat: bool = False,
    use_pallas: bool = False,
) -> torch.Tensor:
    """The loop implementation of :func:`admm_tv` (JAX solver.py:238-283);
    differentiable unless ``use_pallas`` puts K1 in the loop."""
    squeeze = 4 - xin.ndim
    xin = xin.reshape((1,) * squeeze + tuple(xin.shape))
    im_shape = tuple(xin.shape[-2:])
    dtype = xin.dtype
    lmbd = _as_scalar(lmbd, xin)
    rho = _as_scalar(rho, xin)
    tau = lmbd / rho

    freq_c = fdops.freq_denominator(im_shape, rho, kern, dtype, xin.device)
    hty = _htran(xin, kern, im_shape, dtype)

    elementwise = _elementwise_step
    # routing from dtype and mode, decided before anything launches: K1 takes
    # float32 and the per-sample / per-pixel shrinkage modes
    if use_pallas and dtype == torch.float32 and (not iso or iso_mode != "compat"):
        from torch_admm_deconv_tpu_torch.kernels.fused_admm import fused_elementwise_step

        elementwise = fused_elementwise_step

    def step(s, u_x, u_y):
        x = _x_update(s, freq_c, im_shape)
        s, _, _, u_x, u_y = elementwise(x, u_x, u_y, hty, rho, tau, iso, iso_mode)
        return x, s, u_x, u_y

    zeros = torch.zeros_like(xin)
    state = ADMMState(x=zeros, s=hty, u_x=zeros, u_y=zeros)
    for _ in range(maxit):
        if remat and torch.is_grad_enabled():
            state = ADMMState(*checkpoint(step, state.s, state.u_x, state.u_y, use_reentrant=False))
        else:
            state = ADMMState(*step(state.s, state.u_x, state.u_y))
    return state.x.reshape(state.x.shape[squeeze:])


def _residual_norms(x, z_x, z_y, z_x_old, z_y_old, rho, axis_reduce):
    """Scaled-form ADMM residuals (Boyd et al. 3.3; JAX solver.py:286-293)."""
    rx = fdops.dx(x) - z_x
    ry = fdops.dy(x) - z_y
    r = torch.sqrt(axis_reduce(rx * rx + ry * ry))
    sdual = rho * (fdops.dx_t(z_x - z_x_old) + fdops.dy_t(z_y - z_y_old))
    s = torch.sqrt(axis_reduce(sdual * sdual))
    return r, s


class AdaptiveResult(NamedTuple):
    """JAX solver.py:296-301."""

    x: torch.Tensor
    iters: torch.Tensor  # iterations actually run
    r_norm: torch.Tensor  # final primal residual (relative)
    s_norm: torch.Tensor  # final dual residual (relative)
    rho: torch.Tensor  # final penalty


def admm_tv_adaptive(
    xin,
    lmbd,
    rho,
    kern=None,
    iso: bool = False,
    maxit: int = 500,
    *,
    tol: float = 1e-4,
    iso_mode: str = "sample",
    adapt_rho: bool = True,
    rho_mu: float = 10.0,
    rho_scale: float = 2.0,
    check_every: int = 1,
    psum_axis: Optional[str] = None,
    fft_impl: str = "auto",
    device=None,
) -> AdaptiveResult:
    """Classical TV-ADMM with residual stopping and adaptive rho (JAX
    solver.py:308-427): iterate until both relative residuals are <= ``tol``
    or ``maxit`` is hit, one stopping decision for the whole batch. With
    ``adapt_rho`` the penalty follows residual balancing (Boyd 3.4.1): rho
    *= rho_scale when r > rho_mu s, /= rho_scale when s > rho_mu r, the
    scaled duals rescaled by 1/factor, the spectrum rebuilt from the cached
    |H|^2 and |D|^2. The stopping test reads both residuals on the host
    every iteration. ``check_every`` and ``fft_impl`` are accepted for
    parity (the JAX function ignores the first; every value of the second
    runs ``torch.fft``). ``psum_axis`` belongs to the multi-device port and
    raises until then. Not differentiable in JAX (a while loop); use
    :func:`admm_tv` or ``ops.implicit.admm_tv_implicit`` for training.
    ``device``: ``None`` means CUDA; the CPU only when named."""
    if psum_axis is not None:
        raise NotImplementedError("admm_tv_adaptive(psum_axis=...) needs the multi-device port")
    if fft_impl not in FFT_IMPLS:
        raise ValueError(f"unknown fft_impl: {fft_impl!r}")
    dev = resolve_device(device)
    xin = torch.as_tensor(xin, device=dev)
    kern = None if kern is None else torch.as_tensor(kern, device=dev)
    squeeze = 4 - xin.ndim
    xin = xin.reshape((1,) * squeeze + tuple(xin.shape))
    k, (x, *_), r, s, rho_f = _adaptive_loop(
        xin, _as_scalar(lmbd, xin), _as_scalar(rho, xin), kern, iso, maxit, tol, iso_mode,
        adapt_rho, rho_mu, rho_scale,
    )
    return AdaptiveResult(
        x=x.reshape(x.shape[squeeze:]), iters=torch.tensor(k, dtype=torch.int32, device=dev),
        r_norm=r, s_norm=s, rho=rho_f,
    )


def _adaptive_loop(xin, lmbd, rho, kern, iso, maxit, tol, iso_mode, adapt_rho, rho_mu,
                   rho_scale):
    """The residual-stopped loop of :func:`admm_tv_adaptive` on (B, C, H, W)
    with scalar tensors lmbd and rho; also the fixed-rho solve of
    ``ops.implicit`` (``adapt_rho=False``). Returns (iterations, (x, z_x,
    z_y, u_x, u_y), r, s, rho)."""
    im_shape = tuple(xin.shape[-2:])
    dtype, dev = xin.dtype, xin.device
    d2 = fdops.grad_otf_abs2(im_shape, dtype, dev)
    if kern is None or kern.numel() == 0:
        h_abs2 = torch.ones((), dtype=dtype, device=dev)
    else:
        otf = fdops.psf_otf(kern.to(dtype), im_shape)
        h_abs2 = (otf.real**2 + otf.imag**2).reshape(im_shape[0], im_shape[1] // 2 + 1)
    hty = _htran(xin, kern, im_shape, dtype)
    scale = torch.sqrt(torch.tensor(2.0 * xin.numel(), dtype=dtype, device=dev))

    zeros = torch.zeros_like(xin)
    x, z_x, z_y, u_x, u_y = zeros, zeros, zeros, zeros, zeros
    r = s = torch.ones((), dtype=dtype, device=dev)
    k = 0
    while k < maxit and bool((r > tol) | (s > tol)):
        freq_c = 1.0 / (h_abs2 + rho * d2)
        s_rhs = hty + rho * (fdops.dx_t(z_x - u_x) + fdops.dy_t(z_y - u_y))
        x = _x_update(s_rhs, freq_c, im_shape)
        dxk = fdops.dx(x)
        dyk = fdops.dy(x)
        z_x_new, z_y_new = _shrink(dxk + u_x, dyk + u_y, lmbd / rho, iso, iso_mode)
        u_x = u_x + dxk - z_x_new
        u_y = u_y + dyk - z_y_new
        r, s = _residual_norms(x, z_x_new, z_y_new, z_x, z_y, rho, torch.sum)
        r, s = r / scale, s / scale
        z_x, z_y = z_x_new, z_y_new
        if adapt_rho:
            factor = torch.where(r > rho_mu * s, rho_scale,
                                 torch.where(s > rho_mu * r, 1.0 / rho_scale, 1.0)).to(dtype)
            rho = rho * factor
            u_x = u_x / factor
            u_y = u_y / factor
        k += 1
    return k, (x, z_x, z_y, u_x, u_y), r, s, rho


def tv_objective(x, xin, lmbd, kern=None, iso: bool = False, *, device=None):
    """0.5 ||H x - y||^2 + lambda TV(x), a diagnostic (JAX solver.py:430-446).
    ``device``: ``None`` means CUDA; the CPU only when named."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    xin = torch.as_tensor(xin, device=dev)
    if kern is None or torch.as_tensor(kern).numel() == 0:
        hx = x
    else:
        kern = torch.as_tensor(kern, device=dev)
        im_shape = tuple(x.shape[-2:])
        otf_c = fdops.psf_otf_centered(kern.to(x.dtype), im_shape)
        hx = torch.fft.irfft2(otf_c * torch.fft.rfft2(x), s=im_shape)
    data = 0.5 * torch.sum((hx - xin) ** 2)
    gx, gy = fdops.dx(x), fdops.dy(x)
    if iso:
        tv = torch.sum(torch.sqrt(gx * gx + gy * gy + 1e-15))
    else:
        tv = torch.sum(torch.abs(gx) + torch.abs(gy))
    return data + lmbd * tv
