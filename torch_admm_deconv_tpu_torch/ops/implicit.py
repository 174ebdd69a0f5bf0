"""Implicit (fixed-point) gradients for the TV-ADMM solver.

Counterpart of torch_admm_deconv_tpu/ops/implicit.py. One ADMM iteration is
``v' = F(v; theta)`` with state ``v = (x, z_x, z_y, u_x, u_y)`` and
parameters ``theta = (x_in, lambda, rho, kern)``. At the fixed point
``v* = F(v*; theta)`` the implicit function theorem gives the gradient with
cotangent ``w`` on ``v*`` as ``theta_bar = J_theta^T a``, where ``a`` solves
``(I - J_v^T) a = w``; ``a`` comes from the Neumann series
``a <- w + J_v^T a``, one vector-Jacobian product of a single iteration per
term. Memory is O(1) in the forward's iteration count, and the forward is
free to take the fastest residual-stopped solve: the K3 kernel where the
JAX dispatch takes it, else the ``torch.fft`` loop. The backward has no
kernel, as in JAX.
"""

from __future__ import annotations

import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.ops import fdops
from torch_admm_deconv_tpu_torch.ops.solver import _adaptive_loop, _htran, _shrink, _x_update


def _fixed_point_step(v, theta, iso: bool, iso_mode: str, im_shape):
    """One ADMM iteration as a function of (state, parameters), everything
    theta-dependent recomputed so that autograd sees all of it (JAX
    implicit.py:47-74). ``theta`` is (xin, lmbd, rho) or (xin, lmbd, rho,
    kern)."""
    _, z_x, z_y, u_x, u_y = v
    xin, lmbd, rho = theta[:3]
    kern = theta[3] if len(theta) > 3 else None
    dtype = xin.dtype
    freq_c = fdops.freq_denominator(im_shape, rho, kern, dtype, xin.device)
    hty = _htran(xin, kern, im_shape, dtype)
    s = hty + rho * (fdops.dx_t(z_x - u_x) + fdops.dy_t(z_y - u_y))
    x = _x_update(s, freq_c, im_shape)
    dxk = fdops.dx(x)
    dyk = fdops.dy(x)
    z_x, z_y = _shrink(dxk + u_x, dyk + u_y, lmbd / rho, iso, iso_mode)
    u_x = u_x + dxk - z_x
    u_y = u_y + dyk - z_y
    return (x, z_x, z_y, u_x, u_y)


def _solve_full_state(xin, lmbd, rho, kern, iso, maxit, tol, iso_mode):
    """Residual-stopped fixed-rho loop returning the full state (JAX
    implicit.py:77-120): ``admm_tv_adaptive``'s loop with
    ``adapt_rho=False``, one global stopping decision read on the host every
    iteration."""
    return _adaptive_loop(xin, lmbd, rho, kern, iso, maxit, tol, iso_mode, False, 0.0, 1.0)[1]


# the TPU kernel's VMEM budget (JAX vmem_solver.py:52)
_VMEM_BUDGET_BYTES = 100 * 1024 * 1024


def _tpu_takes_kernel(shape, g: int) -> bool:
    """JAX's shape gates for K3 with ``return_state`` and no PSF (JAX
    vmem_solver.py:439-447, 686-699): tile-aligned planes and a block that
    fits the TPU's VMEM budget. The port's kernel needs neither; the
    implicit forward keeps them so that both packages stop per block or
    globally on the same shapes, which decides the state the backward
    linearizes at."""
    h, w = shape[-2], shape[-1]
    if h % 8 != 0 or w % 128 != 0:
        return False
    # 16 g + 2 resident planes and the split cas matrices; the fixed
    # kernel's 10 g + 1 planes fit whenever these do
    return (16 * g + 2) * h * w * 4 + 4 * (h * h + w * w) <= _VMEM_BUDGET_BYTES


def _solve_state_dispatch(xin, lmbd, rho, kern, iso, maxit, tol, iso_mode, precision="high"):
    """The fastest residual-stopped fixed-rho solve returning the full
    state (JAX implicit.py:120-161). K3 runs with residual balancing off
    (``rho_mu=1e30``: a fixed point of the given rho, which is what the
    backward linearizes) exactly where the JAX dispatch takes it: no PSF,
    float32, aniso, 'joint' or 'sample', and the TPU's shape gates. JAX's
    ``admm_tv_implicit`` is jitted, so a PSF there is a tracer whose
    symmetry cannot be read and the kernel's availability check answers no:
    a solve with a PSF takes the loop."""
    from torch_admm_deconv_tpu_torch.kernels.vmem_solver import (
        adaptive_vmem_available,
        admm_tv_adaptive_vmem,
    )

    g = xin.shape[1] if iso and iso_mode == "sample" else 1
    if (kern is None
            and adaptive_vmem_available(xin.shape, xin.dtype, None, iso, iso_mode,
                                        return_state=True)
            and _tpu_takes_kernel(xin.shape, g)):
        _, state = admm_tv_adaptive_vmem(
            xin, lmbd, rho, None, iso=iso, maxit=maxit, tol=tol, iso_mode=iso_mode,
            rho_mu=1e30, return_state=True, precision=precision, device=xin.device,
        )
        return state
    return _solve_full_state(xin, lmbd, rho, kern, iso, maxit, tol, iso_mode)


def neumann_vjp(v_star, theta, g, iso: bool, iso_mode: str, backward_iters: int):
    """theta_bar = J_theta^T a with a <- w + J_v^T a run ``backward_iters``
    times from a = w = (g, 0, 0, 0, 0), all at the state ``v_star`` (JAX
    implicit.py:179-196). ``theta`` is (xin, lmbd, rho) or (xin, lmbd, rho,
    kern); returns one gradient per entry."""
    im_shape = tuple(theta[0].shape[-2:])
    with torch.enable_grad():
        v = [t.detach().requires_grad_() for t in v_star]
        th = [t.detach().requires_grad_() for t in theta]
        out = _fixed_point_step(v, th, iso, iso_mode, im_shape)

        def pullback(a, wrt, retain):
            grads = torch.autograd.grad(out, wrt, grad_outputs=a, retain_graph=retain,
                                        allow_unused=True)
            return [torch.zeros_like(t) if d is None else d for t, d in zip(wrt, grads)]

        zeros = torch.zeros_like(g)
        w = [g, zeros, zeros, zeros, zeros]
        a = w
        for _ in range(backward_iters):
            a = [wi + vi for wi, vi in zip(w, pullback(a, v, True))]
        return pullback(a, th, False)


class _Implicit(torch.autograd.Function):
    """Forward: the dispatch above. Backward: :func:`neumann_vjp` at v*
    (JAX implicit.py:164-196)."""

    @staticmethod
    def forward(ctx, xin, lmbd, rho, kern, iso, maxit, tol, iso_mode, backward_iters, precision):
        v = _solve_state_dispatch(xin, lmbd, rho, kern, iso, maxit, tol, iso_mode, precision)
        ctx.save_for_backward(*v, xin, lmbd, rho, kern)
        ctx.settings = (iso, iso_mode, backward_iters)
        return v[0]

    @staticmethod
    def backward(ctx, g):
        *v_star, xin, lmbd, rho, kern = ctx.saved_tensors
        theta = [xin, lmbd, rho] + ([] if kern is None else [kern])
        theta_bar = neumann_vjp(v_star, theta, g, *ctx.settings)
        if kern is None:
            theta_bar.append(None)
        return (*theta_bar, None, None, None, None, None, None)


def admm_tv_implicit(
    xin,
    lmbd,
    rho,
    kern=None,
    iso: bool = False,
    maxit: int = 500,
    *,
    tol: float = 1e-8,
    iso_mode: str = "sample",
    backward_iters: int = 50,
    precision: str = "high",
    device=None,
) -> torch.Tensor:
    """TV-ADMM with implicit (fixed-point) gradients (JAX implicit.py:199-252).

    Forward: the residual-stopped fixed-rho solve (``tol`` is its stopping
    tolerance; keep it tight). Backward: the implicit-function-theorem
    gradient at the fixed point by a ``backward_iters``-term Neumann series,
    for ``xin``, ``lmbd``, ``rho`` and the PSF ``kern``. Accepts (B, C, H,
    W), (C, H, W) or (H, W). ``device``: ``None`` means CUDA; the CPU only
    when named."""
    dev = resolve_device(device)
    xin = torch.as_tensor(xin, device=dev)
    squeeze = 4 - xin.ndim
    xin = xin.reshape((1,) * squeeze + tuple(xin.shape))
    dtype = xin.dtype
    lmbd = torch.as_tensor(lmbd, dtype=dtype, device=dev).reshape(())
    rho = torch.as_tensor(rho, dtype=dtype, device=dev).reshape(())
    if kern is not None:
        kern = torch.as_tensor(kern, device=dev)
        if kern.numel() == 0:
            kern = None
    out = _Implicit.apply(xin, lmbd, rho, kern, iso, int(maxit), float(tol), iso_mode,
                          int(backward_iters), precision)
    return out.reshape(out.shape[squeeze:])
