"""Spatially split TV-ADMM for megapixel images over ``torch.distributed``.

Counterpart of torch_admm_deconv_tpu/parallel/spatial.py (BASELINE.json
config 5). The image's H axis is split over the ranks of the ``space`` axis:
each function takes this rank's block of H/n rows and returns its block
(``shard_rows`` cuts it from a full image, ``gather_rows`` joins the blocks).
Every iteration needs two structures across ranks:

* **row shifts**: the one-pixel circular shifts of Dy and Dy^T move one
  boundary row to the ring neighbour, a ``batch_isend_irecv`` pair; Dx is
  local;
* **the x-update**, in one of two modes. 'pencil' is the exact distributed
  FFT: a local rfft along W, an ``all_to_all_single`` transpose that makes H
  local (the rfft column axis zero-padded to a multiple of n), a local fft
  along H, the frequency diagonal on this rank's columns (closed-form per
  column, no full-grid array), then the inverse chain: two transposes an
  iteration. 'halo' solves the x-update locally on the block padded with
  ``halo`` rows of each neighbour (one exchange pair), with an error that
  decays exponentially in ``halo``.

The adaptive solver sums its residuals with ``all_reduce``, so every rank
reads the same values and stops and rescales rho at the same iteration.

At n = 1 the ring neighbour is the rank itself, as JAX's permutation is the
identity there: the shifts are local rolls, the halo is the block's own wrap
and the transposes are the identity. Complex spectra cross the transposes as
``torch.view_as_real`` views. The solvers are not differentiable.

Not ported: ``fft_impl`` is accepted and every value runs ``torch.fft``, as
in ``ops.solver.admm_tv``, so the TPU's matmul-DFT stages
(``rfft2_sharded_mxu``, ``irfft2_sharded_mxu``) and the 'dht'/'mxu' local
solvers have no counterpart. JAX's ``lru_cache`` of compiled sharded
programs has none either: eager torch compiles nothing, and the per-column
spectra are two small products a call.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from torch_admm_deconv_tpu_torch._dist import all_reduce_sum, resolve_group, size_rank
from torch_admm_deconv_tpu_torch.ops import fdops
from torch_admm_deconv_tpu_torch.ops.solver import (
    FFT_IMPLS,
    AdaptiveResult,
    _as_scalar,
    _shrink,
    _x_update,
)
from torch_admm_deconv_tpu_torch.parallel.mesh import gather, local_block

X_UPDATE_MODES = ("pencil", "halo")

# ---------------------------------------------------------------------------
# scatter and gather of image rows
# ---------------------------------------------------------------------------


def shard_rows(x: torch.Tensor, mesh, axis: str = "space") -> torch.Tensor:
    """This rank's rows of the full (B, C, H, W) image ``x`` (JAX
    spatial.py:419's divisibility)."""
    n, _ = size_rank(resolve_group(mesh, axis))
    h = x.shape[-2]
    if h % n:
        raise ValueError(f"H={h} must divide over {n} spatial shards")
    return local_block(x, -2, mesh, axis)


def gather_rows(x_local: torch.Tensor, mesh, axis: str = "space") -> torch.Tensor:
    """The full image from every rank's rows, on every rank."""
    return gather(x_local, -2, mesh, axis)


# ---------------------------------------------------------------------------
# halo exchange: row-split one-row circular shifts along H
# ---------------------------------------------------------------------------


def _pass_ring(t: torch.Tensor, to_next: bool, group) -> torch.Tensor:
    """Send ``t`` one step around the ring of ``group`` (to the next rank,
    or to the previous with ``to_next`` False) and return the block that
    arrives from the other side."""
    n, i = size_rank(group)
    dst, src = ((i + 1) % n, (i - 1) % n) if to_next else ((i - 1) % n, (i + 1) % n)
    t = t.contiguous()
    out = torch.empty_like(t)
    ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _shift_rows(x: torch.Tensor, direction: int, group) -> torch.Tensor:
    """Global circular roll of H by +-1 for a row block: one boundary row
    from the ring neighbour (JAX spatial.py:42-54)."""
    if size_rank(group)[0] == 1:
        return torch.roll(x, direction, dims=-2)
    if direction == +1:  # roll down: the row comes from the previous rank
        recv = _pass_ring(x[..., -1:, :], True, group)
        return torch.cat([recv, x[..., :-1, :]], dim=-2)
    recv = _pass_ring(x[..., :1, :], False, group)  # roll up: from the next rank
    return torch.cat([x[..., 1:, :], recv], dim=-2)


def _halo_exchange(v: torch.Tensor, m: int, group) -> torch.Tensor:
    """Pad a row block with ``m`` rows of each circular neighbour: (...,
    H/n, W) -> (..., H/n + 2m, W), the previous rank's last m rows above
    and the next rank's first m rows below (JAX spatial.py:57-71). At n = 1
    the pad is the block's own wrap: the padded problem is then
    (H + 2m)-periodic, not H-periodic, and the margin error remains."""
    if size_rank(group)[0] == 1:
        top, bot = v[..., -m:, :], v[..., :m, :]
    else:
        top = _pass_ring(v[..., -m:, :], True, group)
        bot = _pass_ring(v[..., :m, :], False, group)
    return torch.cat([top, v, bot], dim=-2)


def dy_sharded(x: torch.Tensor, group) -> torch.Tensor:
    return x - _shift_rows(x, +1, group)


def dy_t_sharded(a: torch.Tensor, group) -> torch.Tensor:
    return a - _shift_rows(a, -1, group)


def dx_local(x: torch.Tensor) -> torch.Tensor:
    return x - torch.roll(x, 1, dims=-1)


def dx_t_local(a: torch.Tensor) -> torch.Tensor:
    return a - torch.roll(a, -1, dims=-1)


# ---------------------------------------------------------------------------
# pencil-decomposed distributed FFT
# ---------------------------------------------------------------------------


def _wf_pad(w: int, n: int) -> Tuple[int, int]:
    wf = w // 2 + 1
    return wf, (-wf) % n


def _all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of a complex (n, ...) tensor, block j to rank
    j, as its float view."""
    real = torch.view_as_real(send)
    out = torch.empty_like(real)
    dist.all_to_all_single(out, real, group=group)
    return torch.view_as_complex(out)


def _cols_to_rows(xf: torch.Tensor, group, n: int) -> torch.Tensor:
    """(B, C, H/n, Wp) column chunks out, row blocks in: (B, C, H, Wp/n)
    (JAX's ``all_to_all(split_axis=3, concat_axis=2, tiled=True)``)."""
    if n == 1:
        return xf
    b, c, h, wp = xf.shape
    send = xf.reshape(b, c, h, n, wp // n).permute(3, 0, 1, 2, 4).contiguous()
    recv = _all_to_all(send, group)  # recv[j]: rank j's rows of my columns
    return recv.permute(1, 2, 0, 3, 4).reshape(b, c, n * h, wp // n)


def _rows_to_cols(xf: torch.Tensor, group, n: int) -> torch.Tensor:
    """The inverse of :func:`_cols_to_rows`: (B, C, H, Wp/n) -> (B, C,
    H/n, Wp)."""
    if n == 1:
        return xf
    b, c, hh, cw = xf.shape
    send = xf.reshape(b, c, n, hh // n, cw).permute(2, 0, 1, 3, 4).contiguous()
    recv = _all_to_all(send, group)  # recv[j]: rank j's columns of my rows
    return recv.permute(1, 2, 3, 0, 4).reshape(b, c, hh // n, n * cw)


def rfft2_sharded(x: torch.Tensor, group, n: int, w: int) -> torch.Tensor:
    """(B, C, H/n, W) real, row-split -> (B, C, H, Wp/n) complex, split by
    frequency column, Wp = W//2+1 padded to a multiple of n (JAX
    spatial.py:100-108)."""
    xf = torch.fft.rfft(x, dim=-1)
    _, pad = _wf_pad(w, n)
    if pad:
        xf = torch.cat([xf, xf.new_zeros(*xf.shape[:-1], pad)], dim=-1)
    return torch.fft.fft(_cols_to_rows(xf, group, n), dim=-2)


def irfft2_sharded(xf: torch.Tensor, group, n: int, h_local: int, w: int) -> torch.Tensor:
    """The inverse of :func:`rfft2_sharded`: back to (B, C, H/n, W) real
    (JAX spatial.py:111-119)."""
    xf = _rows_to_cols(torch.fft.ifft(xf, dim=-2), group, n)
    wf, _ = _wf_pad(w, n)
    return torch.fft.irfft(xf[..., :wf], n=w, dim=-1)


# ---------------------------------------------------------------------------
# halo-margin local x-update
# ---------------------------------------------------------------------------
# The inverse of (|H_hat|^2 + rho |D_hat|^2) has a spatial kernel that decays
# exponentially, so the x-update can be solved on the rank's block padded
# with ``halo`` rows of true neighbour data (one exchange pair: 2 m W values
# against the transposes' H/n W), keeping the middle rows. The error decays
# like exp(-m / l), l ~ 1 / acosh(1 + 1 / (2 rho)) rows.


def _make_halo_ops(kern, *, group, n, h_local, w, halo, dtype, device):
    """(x_update(s, freq_c), |H|^2, |D|^2, hty_fn) of the local solve on the
    (h_local + 2 halo, w) padded block; ``freq_c`` = 1 / (|H|^2 + rho
    |D|^2) on that grid (JAX spatial.py:233-272)."""
    if not 0 < halo <= h_local:
        raise ValueError(f"halo={halo} must be in (0, H/n={h_local}]")
    h_pad = h_local + 2 * halo
    shape = (h_pad, w)

    if kern is None or kern.numel() == 0:
        habs2 = torch.ones((), dtype=dtype, device=device)
        hty_fn = lambda v: v  # noqa: E731
    else:
        otf_c = fdops.psf_otf_centered(kern.to(dtype), shape)
        habs2 = (otf_c.real**2 + otf_c.imag**2).reshape(h_pad, w // 2 + 1).to(dtype)

        def hty_fn(v):
            full = fdops.htran_fft(_halo_exchange(v, halo, group), otf_c, shape)
            return full[..., halo : halo + h_local, :]

    d2 = fdops.grad_otf_abs2(shape, dtype, device)

    def x_update(s, freq_c):
        x_pad = _x_update(_halo_exchange(s, halo, group), freq_c, shape)
        return x_pad[..., halo : halo + h_local, :]

    return x_update, habs2, d2, hty_fn


# ---------------------------------------------------------------------------
# closed-form per-column frequency grids
# ---------------------------------------------------------------------------


def _my_cols(group, n: int, w: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's rfft column indices on the padded grid, and which of
    them are real columns (JAX spatial.py:280-286)."""
    wf, pad = _wf_pad(w, n)
    chunk = (wf + pad) // n
    kx = size_rank(group)[1] * chunk + torch.arange(chunk, device=device)
    return kx, kx < wf


def grad_abs2_cols(h: int, w: int, kx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """|Dx_hat|^2 + |Dy_hat|^2 on (H, cols), 4 sin^2 in closed form (JAX
    spatial.py:289-295)."""
    ky = torch.arange(h, dtype=dtype, device=kx.device)
    sy2 = 4.0 * torch.sin(math.pi * ky / h) ** 2
    sx2 = 4.0 * torch.sin(math.pi * kx.to(dtype) / w) ** 2
    return sy2[:, None] + sx2[None, :]


def psf_otf_centered_cols(kern: torch.Tensor, h: int, w: int, kx: torch.Tensor,
                          dtype=torch.float32) -> torch.Tensor:
    """The centered PSF's OTF on (H, cols) by the small-kernel DFT sum in
    the working dtype, kh kw H cols products and no full-grid FFT (JAX
    spatial.py:298-313; ``ops.fdops.psf_otf_centered`` on these columns)."""
    kh, kw = int(kern.shape[-2]), int(kern.shape[-1])
    top, left = (kh - 1) // 2, (kw - 1) // 2
    dev = kx.device
    k = kern.reshape(kh, kw).to(dtype)
    a = torch.arange(kh, dtype=dtype, device=dev) - top
    b = torch.arange(kw, dtype=dtype, device=dev) - left
    ky = torch.arange(h, dtype=dtype, device=dev)
    py = torch.exp(-2j * math.pi * a[:, None] * ky[None, :] / h)  # (kh, H)
    px = torch.exp(-2j * math.pi * b[:, None] * kx.to(dtype)[None, :] / w)  # (kw, cols)
    return torch.einsum("ab,ay,bx->yx", k.to(py.dtype), py, px)


# ---------------------------------------------------------------------------
# the row-split solvers
# ---------------------------------------------------------------------------


def _x_solver(xin, kern, *, group, n, w, x_update_mode, halo):
    """(solve_x(s, rho), hty) for a row block: the pencil FFT with this
    rank's masked spectrum columns, or the halo-margin local solve."""
    dtype, dev = xin.dtype, xin.device
    h_local = xin.shape[-2]
    if x_update_mode == "halo":
        x_up, h_abs2, d2, hty_fn = _make_halo_ops(
            kern, group=group, n=n, h_local=h_local, w=w, halo=halo, dtype=dtype, device=dev)
        return (lambda s, rho: x_up(s, 1.0 / (h_abs2 + rho * d2))), hty_fn(xin)
    h = h_local * n
    kx, valid = _my_cols(group, n, w, dev)
    d2 = grad_abs2_cols(h, w, kx, dtype)
    if kern is None:
        h_abs2 = torch.ones((), dtype=dtype, device=dev)
        hty = xin
    else:
        otf_c = psf_otf_centered_cols(kern, h, w, kx, dtype)
        h_abs2 = (otf_c.real**2 + otf_c.imag**2).to(dtype)
        hty = irfft2_sharded(torch.conj(otf_c) * rfft2_sharded(xin, group, n, w), group, n,
                             h_local, w)

    def solve_x(s, rho):
        # freq_c is 0 on the padded columns
        freq_c = torch.where(valid[None, :], 1.0 / (h_abs2 + rho * d2), 0.0)
        return irfft2_sharded(freq_c * rfft2_sharded(s, group, n, w), group, n, h_local, w)

    return solve_x, hty


def _prepare(xin, kern, fft_impl, x_update_mode, mesh, axis):
    if fft_impl not in FFT_IMPLS:
        raise ValueError(f"unknown fft_impl: {fft_impl!r}")
    if x_update_mode not in X_UPDATE_MODES:
        raise ValueError(f"unknown x_update_mode: {x_update_mode!r}")
    group = resolve_group(mesh, axis)
    xin = torch.as_tensor(xin)
    if xin.ndim != 4:
        raise ValueError(f"xin must be a (B, C, H/n, W) row block, got {tuple(xin.shape)}")
    if kern is not None:
        kern = torch.as_tensor(kern, device=xin.device)
        kern = None if kern.numel() == 0 else kern
    return group, size_rank(group)[0], xin, kern


@torch.no_grad()
def spatial_admm_tv(
    xin: torch.Tensor,
    lmbd,
    rho,
    kern: Optional[torch.Tensor] = None,
    iso: bool = False,
    maxit: int = 100,
    *,
    mesh,
    axis: str = "space",
    iso_mode: str = "compat",
    fft_impl: str = "auto",
    x_update_mode: str = "pencil",
    halo: int = 32,
) -> torch.Tensor:
    """Fixed-iteration TV-ADMM with the image's rows split over ``axis`` of
    ``mesh`` (a ``DeviceMesh``, or a ``ProcessGroup``) (JAX
    spatial.py:339-436).

    ``xin``: this rank's (B, C, H/n, W) rows (``shard_rows``); returns its
    rows of the result. 'compat' and 'sample' norms reduce over (B, C), which
    every row block holds whole at its pixels, so they are local.

    ``x_update_mode``: 'pencil' runs the exact distributed-FFT x-update (two
    transposes an iteration) and matches ``ops.solver.admm_tv`` to float
    tolerance; 'halo' solves it locally on a ``halo``-row padded block (one
    exchange pair an iteration), with an error that decays exponentially in
    ``halo``. ``fft_impl`` is accepted; every value runs ``torch.fft``.
    """
    group, n, xin, kern = _prepare(xin, kern, fft_impl, x_update_mode, mesh, axis)
    w = xin.shape[-1]
    lmbd, rho = _as_scalar(lmbd, xin), _as_scalar(rho, xin)
    tau = lmbd / rho
    solve_x, hty = _x_solver(xin, kern, group=group, n=n, w=w, x_update_mode=x_update_mode,
                             halo=halo)
    zeros = torch.zeros_like(xin)
    s, u_x, u_y, x = hty, zeros, zeros, zeros
    for _ in range(maxit):
        x = solve_x(s, rho)
        dxk = dx_local(x)
        dyk = dy_sharded(x, group)
        z_x, z_y = _shrink(dxk + u_x, dyk + u_y, tau, iso, iso_mode)
        u_x = u_x + dxk - z_x
        u_y = u_y + dyk - z_y
        s = hty + rho * (dx_t_local(z_x - u_x) + dy_t_sharded(z_y - u_y, group))
    return x


@torch.no_grad()
def spatial_admm_tv_adaptive(
    xin: torch.Tensor,
    lmbd,
    rho,
    kern: Optional[torch.Tensor] = None,
    iso: bool = False,
    maxit: int = 500,
    *,
    tol: float = 1e-4,
    mesh,
    axis: str = "space",
    iso_mode: str = "sample",
    adapt_rho: bool = True,
    rho_mu: float = 10.0,
    rho_scale: float = 2.0,
    fft_impl: str = "auto",
    x_update_mode: str = "pencil",
    halo: int = 32,
) -> AdaptiveResult:
    """Residual-stopped TV-ADMM with adaptive rho on a row block (JAX
    spatial.py:470-607): both residual sums are all-reduced over ``axis``
    in one call an iteration, so every rank stops and rescales rho
    together; the relative residuals are scaled by sqrt(2 * global numel).
    Returns ``AdaptiveResult`` with this rank's rows in ``x``.
    ``x_update_mode``/``halo`` as in :func:`spatial_admm_tv`."""
    group, n, xin, kern = _prepare(xin, kern, fft_impl, x_update_mode, mesh, axis)
    w = xin.shape[-1]
    dtype, dev = xin.dtype, xin.device
    lmbd, rho_k = _as_scalar(lmbd, xin), _as_scalar(rho, xin)
    solve_x, hty = _x_solver(xin, kern, group=group, n=n, w=w, x_update_mode=x_update_mode,
                             halo=halo)
    scale = torch.sqrt(torch.tensor(2.0 * xin.numel() * n, dtype=dtype, device=dev))
    zeros = torch.zeros_like(xin)
    x, z_x, z_y, u_x, u_y = zeros, zeros, zeros, zeros, zeros
    r = s_res = torch.ones((), dtype=dtype, device=dev)
    k = 0
    while k < maxit and bool((r > tol) | (s_res > tol)):
        s_rhs = hty + rho_k * (dx_t_local(z_x - u_x) + dy_t_sharded(z_y - u_y, group))
        x = solve_x(s_rhs, rho_k)
        dxk = dx_local(x)
        dyk = dy_sharded(x, group)
        z_x_new, z_y_new = _shrink(dxk + u_x, dyk + u_y, lmbd / rho_k, iso, iso_mode)
        u_x = u_x + dxk - z_x_new
        u_y = u_y + dyk - z_y_new
        rx, ry = dxk - z_x_new, dyk - z_y_new
        sd = rho_k * (dx_t_local(z_x_new - z_x) + dy_t_sharded(z_y_new - z_y, group))
        sums = all_reduce_sum(torch.stack([torch.sum(rx * rx + ry * ry), torch.sum(sd * sd)]),
                              group)
        r, s_res = torch.sqrt(sums[0]) / scale, torch.sqrt(sums[1]) / scale
        z_x, z_y = z_x_new, z_y_new
        if adapt_rho:
            factor = torch.where(r > rho_mu * s_res, rho_scale,
                                 torch.where(s_res > rho_mu * r, 1.0 / rho_scale, 1.0)).to(dtype)
            rho_k = rho_k * factor
            u_x = u_x / factor
            u_y = u_y / factor
        k += 1
    return AdaptiveResult(x=x, iters=torch.tensor(k, dtype=torch.int32, device=dev),
                          r_norm=r, s_norm=s_res, rho=rho_k)
