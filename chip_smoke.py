"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``torch_admm_deconv_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, and drives two
main paths, each with the launch counts set to 0 just before and read just
after: (1) the flagship DivergentRestorer forward at full width, classical
tiled TV-ADMM serving and the solver loop with the fused step (phases 4-6);
(2) the interleaved classical batch, the residual-stopped classical solve
at full size and implicit-gradient training steps (phases 8-10). It checks
their outputs and prints one JSON line of kernel numbers and, last, one
JSON status line. Exits non-zero, with no result line, when there is no GPU
or a phase fails.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
CHAIN_FLOPS_PER_PIXEL = 25  # differences, shrinkage, dual update, adjoint sum
# K3's chain adds the residuals and their sums, the dual rescale and the
# rebuilt spectrum of the epilogue
ADAPTIVE_CHAIN_FLOPS_PER_PIXEL = 50


def log(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int, replays: int = 5) -> float:
    """Mean device time of one ``fn`` call, from a CUDA graph of ``calls``
    calls replayed ``replays`` times: no host launch cost between kernels,
    so a short kernel is timed rather than the Python that launches it."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def require(ok: bool, what: str) -> None:
    """Fail the run (non-zero exit, no result line) unless ``ok``."""
    if not ok:
        raise RuntimeError(what)


def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def gaussian_psf(size: int, sigma: float) -> np.ndarray:
    ax = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(ax**2) / (2.0 * sigma**2))
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)[None, None]


def motion_psf(size: int = 9) -> np.ndarray:
    k = np.zeros((1, 1, size, size), np.float32)
    k[0, 0, size // 2, size // 2 :] = np.linspace(1.0, 0.2, size - size // 2)
    return k / k.sum()


def synthetic_image(rng: np.random.Generator, c: int, h: int, w: int) -> np.ndarray:
    """Piecewise-smooth test image in [0.1, 0.9]: a gradient, boxes, discs."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.empty((c, h, w), np.float32)
    for ch in range(c):
        base = 0.3 + 0.2 * (xx / w) + 0.1 * ch / c
        for _ in range(12):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            if rng.random() < 0.5:
                hh, ww = rng.integers(h // 16, h // 4), rng.integers(w // 16, w // 4)
                base[y0 : y0 + hh, x0 : x0 + ww] = rng.uniform(0.1, 0.9)
            else:
                r = rng.integers(h // 20, h // 6)
                base[(yy - y0) ** 2 + (xx - x0) ** 2 < r * r] = rng.uniform(0.1, 0.9)
        img[ch] = base
    return np.clip(img, 0.1, 0.9)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    return float(10.0 * math.log10(1.0 / np.mean((a - b) ** 2)))


def transform_flops(h: int, w: int, n_mats: int) -> int:
    """Flops of one transform of one plane: 2 products (cas) or 4
    (Hartley pair), each 2 h w (h or w)."""
    return (2 if n_mats == 2 else 4) * h * w * (h + w)


def adaptive_bound(iters, g: int, h: int, w: int, n_mats: int, planes_io: int):
    """(bound_ms, bound_by, GFLOP) of a K3 solve: the operations of the
    iterations this run's blocks actually ran, against the bytes of reading
    hty and writing ``planes_io`` - 1 output planes per input plane."""
    per_block = g * (2 * transform_flops(h, w, n_mats) + ADAPTIVE_CHAIN_FLOPS_PER_PIXEL * h * w)
    flops = int(np.asarray(iters).sum()) * per_block
    n_planes = len(iters) * g
    nbytes = planes_io * n_planes * h * w * 4 + (2 * h * w + n_mats * h * h) * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", flops / 1e9


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest relative difference of two small vectors."""
    return float(((a.double() - b.double()).abs() / b.double().abs()).max())


def k3_vs_plain(dev, tile, psfs):
    """Phase 7: K3 against its plain version at (1, 3, 256, 256). Each case
    runs an exact trajectory (tol 0, 60 iterations) and a real stop (tol
    1e-4, at most 500 iterations)."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver

    xt = torch.from_numpy(tile[None]).to(dev)
    cases = [
        # name, iso, iso_mode, psf, precision, rho_mu, return_state
        ("sample", True, "sample", None, "high", 10.0, False),
        ("aniso_gauss9", False, "sample", "gauss", "high", 10.0, False),
        ("aniso_motion9", False, "sample", "motion", "high", 10.0, False),
        ("joint", True, "joint", None, "high", 10.0, False),
        ("sample_mixed", True, "sample", None, "mixed", 10.0, False),
        ("sample_state", True, "sample", None, "high", 1e30, True),
    ]
    out = {}
    for name, iso, iso_mode, psf, precision, rho_mu, state in cases:
        kern = None if psf is None else torch.from_numpy(psfs[psf]).to(dev)
        lmbd, rho = (0.05, 0.8) if psf is None else (0.01, 1.0)
        # f32 SIMT products against cuBLAS f32: 2e-4 (the K2 bar); 'mixed'
        # rounds operands to bf16, where a one-ulp flip between the two
        # summation orders survives the exact tail: 2e-3
        x_tol = 2e-4 if precision == "high" else 2e-3
        launched = vmem_solver.ADAPTIVE_LAUNCHES.n
        for tol, maxit in ((0.0, 60), (1e-4, 500)):
            cfg = vmem_solver.adaptive_config(xt.shape, iso, iso_mode, maxit, tol, rho_mu, 2.0,
                                              precision, None, state)
            hty, habs2, d2, lr, mats = vmem_solver.adaptive_inputs(xt, lmbd, rho, kern, cfg.g)
            run = lambda: vmem_solver._AdaptiveSolve.apply(hty, habs2, d2, lr, cfg, *mats)  # noqa: E731, B023
            plain = lambda: vmem_solver.admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lr, cfg)  # noqa: E731, B023
            got, want = run(), plain()
            torch.cuda.synchronize()
            planes = (0, 1, 2, 3, 4) if state else (0,)
            err = max(max_diff(got[i], want[i]) for i in planes)
            iters_k, iters_p = got[5].cpu(), want[5].cpu()
            r, sd, rho_f = (got[i].cpu() for i in (6, 7, 8))
            require(all(torch.isfinite(got[i]).all() for i in planes), f"K3 {name}: non-finite output")
            if tol == 0.0:
                dev_r = max(rel(got[i].cpu(), want[i].cpu()) for i in (6, 7, 8))
                log(f"K3 {name} tol 0 x{maxit} ({len(mats)} matrices): max|diff| {err:.3e} "
                    f"(tol {x_tol}), iters {iters_k.tolist()} / {iters_p.tolist()}, "
                    f"r, s, rho max rel diff {dev_r:.3e} (tol 1e-3)")
                require(err <= x_tol, f"K3 {name} disagrees: {err}")
                require(torch.equal(iters_k, iters_p), f"K3 {name}: iteration counts differ")
                require(dev_r <= 1e-3, f"K3 {name}: residuals or rho disagree: {dev_r}")
                continue
            done = ((r <= tol) & (sd <= tol)) | (iters_k == maxit)
            done_p = ((want[6].cpu() <= tol) & (want[7].cpu() <= tol)) | (iters_p == maxit)
            gap = (iters_k - iters_p).abs()
            for b in torch.nonzero(gap).flatten().tolist():
                log(f"  K3 {name} block {b}: iters {int(iters_k[b])} vs plain {int(iters_p[b])}, "
                    f"margins r - tol {float(r[b]) - tol:.3e} / {float(want[6][b]) - tol:.3e}, "
                    f"s - tol {float(sd[b]) - tol:.3e} / {float(want[7][b]) - tol:.3e}")
            ms = cuda_ms(run, 3)
            plain_ms = cuda_ms(plain, 3)
            bound_ms, bound_by, gflop = adaptive_bound(iters_k, cfg.g, *xt.shape[-2:], len(mats),
                                                       6 if state else 2)
            log(f"K3 {name} tol {tol} (max {maxit}): iters {iters_k.tolist()} / plain "
                f"{iters_p.tolist()}, max r {float(r.max()):.3e} s {float(sd.max()):.3e}, "
                f"rho {rho_f.tolist()}, max|diff| {err:.3e}; {ms:.3f} ms (CUDA events), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {gflop:.2f} GFLOP)")
            require(bool(done.all()) and bool(done_p.all()),
                    f"K3 {name}: a block stopped before reaching tol")
            require(int(gap.max()) <= 1, f"K3 {name}: iteration counts differ by more than 1")
            out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None, "iters": iters_k.tolist(),
                         "max_abs_err": err,
                         "launches": vmem_solver.ADAPTIVE_LAUNCHES.n - launched}
    return out


def k4_vs_plain_and_k2(dev, batch8, psfs):
    """Phase 8: K4 against its plain version and against K2 at
    (8, 3, 256, 256), 100 iterations, each timed beside K2."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver

    xb = torch.from_numpy(batch8).to(dev)
    cases = [
        ("aniso", False, "joint", None, "high"),
        ("joint", True, "joint", None, "high"),
        ("aniso_motion9", False, "joint", "motion", "high"),
        ("aniso_mixed", False, "joint", None, "mixed"),
        ("joint_mixed", True, "joint", None, "mixed"),
    ]
    out = {}
    for name, iso, iso_mode, psf, precision in cases:
        kern = None if psf is None else torch.from_numpy(psfs[psf]).to(dev)
        lmbd, rho = (0.05, 1.0) if psf is None else (0.01, 1.0)
        hty, freq, rho_t, tau_t, mats = vmem_solver.solve_inputs(xb, lmbd, rho, kern)
        mode = iso_mode if iso else None
        fast = vmem_solver.fast_iterations(precision, 0.75, 100)
        pack = vmem_solver._fixed_pack(xb.shape, iso, iso_mode)
        k4 = lambda: vmem_solver._WholeSolve.apply(hty, freq, rho_t, tau_t, mode, 100, fast, pack, *mats)  # noqa: E731, B023
        k2 = lambda: vmem_solver._WholeSolve.apply(hty, freq, rho_t, tau_t, mode, 100, fast, None, *mats)  # noqa: E731, B023
        plain = lambda: vmem_solver.admm_tv_vmem_interleaved_plain(hty, freq, mats, rho_t, tau_t, mode, 100, fast)  # noqa: E731, B023
        got, want, batched = k4(), plain(), k2()
        torch.cuda.synchronize()
        err, err_k2 = max_diff(got, want), max_diff(got, batched)
        # the K2 bars: 2e-4 'high', 2e-3 'mixed'; against K2 in 'high' the
        # JAX test's 2e-4 (tests/test_vmem_solver.py:170-198). In 'mixed' the
        # left-first transform rounds at other points than K2's: printed only
        x_tol = 2e-4 if precision == "high" else 2e-3
        require(torch.isfinite(got).all(), f"K4 {name}: non-finite output")
        require(err <= x_tol, f"K4 {name} disagrees with its plain version: {err}")
        if precision == "high":
            require(err_k2 <= 2e-4, f"K4 {name} disagrees with K2: {err_k2}")
        ms, k2_ms = cuda_ms(k4, 3), cuda_ms(k2, 3)
        log(f"K4 {name} (8, 3, 256, 256) x100 pack {pack} ({len(mats)} matrices): max|diff| plain "
            f"{err:.3e} (tol {x_tol}), K2 {err_k2:.3e}; K4 {ms:.3f} ms, K2 {k2_ms:.3f} ms "
            f"(CUDA events)")
        out[name] = {"ms": ms, "k2_ms": k2_ms, "max_abs_err": err, "err_vs_k2": err_k2}
        if name == "aniso":
            h = w = 256
            flops = 100 * xb.shape[0] * xb.shape[1] * (2 * transform_flops(h, w, len(mats))
                                                       + CHAIN_FLOPS_PER_PIXEL * h * w)
            nbytes = 2 * xb.numel() * 4 + h * w * 4 + len(mats) * h * h * 4
            out["entry"] = {
                "name": "admm_tv_vmem_interleaved", "route": "cuda",
                "source": "torch_admm_deconv_tpu_torch/csrc/vmem_solver.cu",
                "replaces": "torch_admm_deconv_tpu/kernels/vmem_solver.py:134",
                "max_abs_err": err, "ms": ms, "plain_ms": cuda_ms(plain, 1),
                "bound_ms": max(nbytes / PEAK_BYTES, flops / PEAK_F32_FLOPS) * 1e3,
                "bound_by": "operations" if flops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES else "bytes",
                "library_ms": None}
            out["k2_out"] = batched
    return out


def classical_full_size(dev, rng):
    """Phase 9: the residual-stopped classical solve at (8, 3, 512, 512),
    the JAX package's configuration (scripts/bench_mixed_precision.py:35-37,
    84-103): aniso, lambda 0.05, rho 0.8, maxit 2000, tol 1e-5."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv_adaptive

    clean = np.stack([synthetic_image(rng, 3, 512, 512) for _ in range(8)])
    noisy = clean + rng.normal(0.0, 15.0 / 255.0, clean.shape).astype(np.float32)
    xt = torch.from_numpy(noisy).to(dev)
    kw = dict(iso=False, maxit=2000, tol=1e-5)
    loop = admm_tv_adaptive(xt, 0.05, 0.8, None, device=dev, **kw)
    p_in = psnr(noisy, clean)
    out = {"psnr_in": p_in, "loop_iters": int(loop.iters)}
    for precision in ("high", "mixed"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = vmem_solver.admm_tv_adaptive_vmem(xt, 0.05, 0.8, None, precision=precision,
                                                device=dev, **kw)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        iters = res.iters.cpu()
        r_max, s_max = float(res.r_norm.max()), float(res.s_norm.max())
        p_out = psnr(res.x.cpu().numpy(), clean)
        loop_err = max_diff(res.x, loop.x)
        bound_ms, bound_by, gflop = adaptive_bound(iters, 1, 512, 512, 2, 2)
        log(f"K3 classical (8, 3, 512, 512) {precision}: {ms:.3f} ms (CUDA events), iters "
            f"{iters.tolist()} (sum {int(iters.sum())}; the loop {int(loop.iters)} x 24 planes), "
            f"max r {r_max:.3e} s {s_max:.3e} (tol 1e-5), PSNR {p_in:.3f} -> {p_out:.3f} dB, "
            f"max|K3 - loop| {loop_err:.3e} (tol 5e-3), bound {bound_ms:.3f} ms ({bound_by}, "
            f"{gflop:.1f} GFLOP)")
        require(torch.isfinite(res.x).all(), f"K3 classical {precision}: non-finite output")
        require(r_max <= 1e-5 and s_max <= 1e-5, f"K3 classical {precision}: residuals above tol")
        require(p_out > p_in, f"K3 classical {precision}: no PSNR gain")
        # per-block stopping here, global stopping in the loop: the JAX
        # test's bar (tests/test_vmem_solver.py:130)
        require(loop_err <= 5e-3, f"K3 classical {precision} disagrees with the loop: {loop_err}")
        out[precision] = {"ms": ms, "iters": iters.tolist(), "r_max": r_max, "s_max": s_max,
                          "psnr_out": p_out, "err_vs_loop": loop_err, "bound_ms": bound_ms}
        if precision == "high":
            cfg = vmem_solver.adaptive_config(xt.shape, False, "sample", 2000, 1e-5, 10.0, 2.0,
                                              "high", None, False)
            hty, habs2, d2, lr, mats = vmem_solver.adaptive_inputs(xt, 0.05, 0.8, None, 1)
            start.record()
            want = vmem_solver.admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lr, cfg)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            err = max_diff(res.x, want[0].reshape(xt.shape))
            gap = int((iters - want[5].cpu()).abs().max())
            log(f"K3 classical high vs plain: max|diff| {err:.3e} (tol 2e-4), iters differ by at "
                f"most {gap}; plain {plain_ms:.3f} ms")
            require(err <= 2e-4 and gap <= 1, f"K3 classical disagrees with its plain version: {err}")
            out["entry"] = {
                "name": "admm_tv_adaptive_vmem", "route": "cuda",
                "source": "torch_admm_deconv_tpu_torch/csrc/vmem_adaptive.cu",
                "replaces": "torch_admm_deconv_tpu/kernels/vmem_solver.py:505",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}
    return out


def implicit_training(dev, tile, clean_tile):
    """Phase 10: implicit-gradient training at full width. (a) the ADMM
    layer in 'sample' mode, whose forward is K3; (b) the flagship, whose
    'compat' layers keep the loop in both packages."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver
    from torch_admm_deconv_tpu_torch.models.admm_deconv import ADMMDeconv
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer
    from torch_admm_deconv_tpu_torch.ops import implicit

    clean = torch.from_numpy(clean_tile[None]).to(dev)
    xin = torch.from_numpy(tile[None]).to(dev)
    out = {}

    # (a) lambda and rho learnable, set to the classical values
    layer = ADMMDeconv(iso=True, iso_mode="sample", gradient_mode="implicit", max_iters=500,
                       device=dev, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.lmbda.fill_(0.05)
        layer.rho.fill_(1.0)

    def layer_step():
        layer.zero_grad()
        x = xin.clone().requires_grad_(True)
        before = vmem_solver.ADAPTIVE_LAUNCHES.n
        t0 = time.perf_counter()
        y = layer(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.mean((y - clean) ** 2).backward()
        torch.cuda.synchronize()
        launched = vmem_solver.ADAPTIVE_LAUNCHES.n - before
        require(launched == 1, f"the implicit layer's forward must launch K3 once, launched {launched}")
        return x, t1 - t0, time.perf_counter() - t1

    layer_step()  # warm-up: first-call costs of the FFT plans and autograd
    x, fwd_s, bwd_s = layer_step()
    lm, rh = layer.lmbda.detach().reshape(()), layer.rho.detach().reshape(())
    with torch.no_grad():
        res, k3_state = vmem_solver.admm_tv_adaptive_vmem(
            xin, lm, rh, None, iso=True, iso_mode="sample", maxit=500, tol=1e-6, rho_mu=1e30,
            precision="high", return_state=True, device=dev)
        loop_state = implicit._solve_full_state(xin, lm, rh, None, True, 500, 1e-6, "sample")
    state_err = max(max_diff(a, b) for a, b in zip(k3_state, loop_state))
    y_ref = loop_state[0].clone().requires_grad_(True)
    g = torch.autograd.grad(torch.mean((y_ref - clean) ** 2), y_ref)[0]
    ref = implicit.neumann_vjp(loop_state, [xin, lm, rh], g, True, "sample", 50)
    got = [x.grad, layer.lmbda.grad.reshape(()), layer.rho.grad.reshape(())]
    # the xin gradient as a field, by its relative L2 norm: shrinkage's
    # Jacobian jumps where |D x + u| crosses tau, so exit states 2e-4 apart
    # put a few pixels on the other side and move single entries by ~1 % of
    # the largest (printed as max_rel)
    err_x = float((got[0] - ref[0]).norm() / ref[0].norm())
    max_x = max_diff(got[0], ref[0]) / float(ref[0].abs().max())
    err_l = abs(float(got[1] - ref[1])) / abs(float(ref[1]))
    # rho's gradient is 0 at the fixed point (the solution does not depend on
    # rho): both values are the forward's stopping error, so rho is held to
    # 1e-2 of lambda's gradient
    err_r = abs(float(got[2] - ref[2])) / abs(float(ref[1]))
    log(f"implicit ADMM layer (1, 3, 256, 256) sample: K3 launches 1 per forward, K3 iters "
        f"{res.iters.tolist()}; warm step forward {fwd_s:.4f} s, backward {bwd_s:.4f} s; exit "
        f"state max|K3 - loop| {state_err:.3e} (tol 1e-3); gradients against the loop state's: "
        f"xin rel L2 {err_x:.3e} (max_rel {max_x:.3e}), lambda rel {err_l:.3e} "
        f"({float(got[1]):.6e} vs {float(ref[1]):.6e}), rho {err_r:.3e} of lambda's "
        f"({float(got[2]):.3e} vs {float(ref[2]):.3e}) (tol 1e-2)")
    require(state_err <= 1e-3, f"implicit layer: K3 exit state disagrees with the loop: {state_err}")
    require(max(err_x, err_l, err_r) <= 1e-2, "implicit layer: gradients disagree with the loop's")
    out["layer_forward_s"], out["layer_backward_s"] = fwd_s, bwd_s

    # (b) the flagship at full width, the train.py --gradient_mode implicit path
    model = flagship_divergent_restorer(gradient_mode="implicit", device=dev,
                                        generator=torch.Generator().manual_seed(0))
    times = []
    for _ in range(2):  # a warm-up step, then the timed one
        model.zero_grad()
        t0 = time.perf_counter()
        loss = torch.mean((model(xin) - clean) ** 2)
        loss.backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    flag_s = times[-1]
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads)
    nonzero = sum(bool(gr.abs().max() > 0) for gr in grads)
    log(f"implicit flagship (1, 3, 256, 256): forward+backward {flag_s:.3f} s (first step "
        f"{times[0]:.3f} s), loss "
        f"{float(loss.detach()):.6f}, {len(grads)} parameter gradients, {nonzero} nonzero, finite {finite}")
    require(bool(torch.isfinite(loss)) and finite and nonzero > 0,
            "implicit flagship: gradients not finite or all zero")
    out["flagship_s"] = flag_s
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from torch_admm_deconv_tpu_torch.kernels import fused_admm, vmem_solver
    from torch_admm_deconv_tpu_torch.kernels._build import LIBRARIES
    from torch_admm_deconv_tpu_torch.infer import classical_restorer, restore_image
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer
    from torch_admm_deconv_tpu_torch.ops.solver import _elementwise_step, admm_tv

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)

    # -- phase 1: the card and the build -------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    LIBRARIES.build()
    LIBRARIES.load("fused_admm")
    LIBRARIES.load("vmem_solver")
    LIBRARIES.load("vmem_adaptive")
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {LIBRARIES.build_seconds} s)")
    if LIBRARIES.ptxas_log:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", LIBRARIES.ptxas_log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", LIBRARIES.ptxas_log))
        log(f"ptxas: {len(regs)} kernels, max {max(regs)} registers/thread, {spills} bytes spilled")

    # -- phase 2: K1 against its plain version -------------------------------
    # same float32 chain, different association and FMA contraction: 1e-5
    k1_tol = 1e-5
    k1_flagship = None
    for shape in ((1, 3, 256, 256), (2, 3, 250, 190)):
        for iso, mode in ((False, "joint"), (True, "sample"), (True, "joint")):
            x, ux, uy, hty = (torch.randn(shape, device=dev) for _ in range(4))
            got = fused_admm.fused_elementwise_step(x, ux, uy, hty, 0.7, 0.15, iso, mode)
            want = _elementwise_step(x, ux, uy, hty, 0.7, 0.15, iso, mode)
            err = max(max_diff(got[i], want[i]) for i in (0, 3, 4))
            name = mode if iso else "aniso"
            log(f"K1 {name} {shape}: max|diff| {err:.3e} (tol {k1_tol})")
            require(err <= k1_tol, f"K1 {name} {shape} disagrees: {err}")
            if shape == (1, 3, 256, 256) and mode == "sample" and iso:
                k1_flagship = (err, (x, ux, uy, hty))
    err, (x, ux, uy, hty) = k1_flagship
    rho_c, tau_c = torch.tensor(0.7, device=dev), torch.tensor(0.15, device=dev)
    k1_ms = graph_ms(lambda: fused_admm.fused_elementwise_step(x, ux, uy, hty, rho_c, tau_c, True, "sample"), 100)
    k1_plain_ms = graph_ms(lambda: _elementwise_step(x, ux, uy, hty, rho_c, tau_c, True, "sample"), 100)
    k1_call_ms = cuda_ms(lambda: fused_admm.fused_elementwise_step(x, ux, uy, hty, rho_c, tau_c, True, "sample"), 200, 5)
    k1_bytes = 7 * x.numel() * 4
    k1_ops = CHAIN_FLOPS_PER_PIXEL * x.numel()
    k1 = {"name": "fused_elementwise_step", "route": "cuda",
          "source": "torch_admm_deconv_tpu_torch/csrc/fused_admm.cu",
          "replaces": "torch_admm_deconv_tpu/kernels/fused_admm.py:42",
          "max_abs_err": err, "ms": k1_ms, "plain_ms": k1_plain_ms,
          "bound_ms": max(k1_bytes / PEAK_BYTES, k1_ops / PEAK_F32_FLOPS) * 1e3,
          "bound_by": "bytes" if k1_bytes / PEAK_BYTES >= k1_ops / PEAK_F32_FLOPS else "operations",
          "library_ms": None}
    log(f"K1 (1, 3, 256, 256) sample: {k1_ms:.4f} ms (CUDA graph), plain {k1_plain_ms:.4f} ms, "
        f"bound {k1['bound_ms']:.4f} ms; eager call incl. Python {k1_call_ms:.4f} ms")

    # -- phase 3: K2 against its plain version -------------------------------
    tile = synthetic_image(rng, 3, 256, 256)
    noisy_tile = tile + rng.normal(0.0, 15.0 / 255.0, tile.shape).astype(np.float32)
    gauss, motion = gaussian_psf(9, 1.5), motion_psf(9)
    batch8 = np.stack([synthetic_image(rng, 3, 256, 256) for _ in range(8)])
    batch8 += rng.normal(0.0, 15.0 / 255.0, batch8.shape).astype(np.float32)
    # f32 SIMT products against cuBLAS f32 over 100 nonlinear iterations: 2e-4;
    # 'mixed' rounds operands to bf16, where a one-ulp flip (~4e-3 relative)
    # between the two summation orders survives a 25-iteration tail: 2e-3
    cases = [
        ("sample", noisy_tile[None], None, True, "sample", "high", 0.05, 1.0, 2e-4),
        ("aniso_gauss9", noisy_tile[None], gauss, False, "joint", "high", 0.01, 1.0, 2e-4),
        ("aniso_motion9", noisy_tile[None], motion, False, "joint", "high", 0.01, 1.0, 2e-4),
        ("aniso_mixed", noisy_tile[None], None, False, "joint", "mixed", 0.05, 1.0, 2e-3),
        ("aniso_batch8", batch8, None, False, "joint", "high", 0.05, 1.0, 2e-4),
    ]
    k2_flagship = None
    extra_ms = {}
    for name, xin, kern, iso, iso_mode, precision, lmbd, rho, tol in cases:
        xt = torch.from_numpy(np.ascontiguousarray(xin)).to(dev)
        kt = None if kern is None else torch.from_numpy(kern).to(dev)
        hty_, freq, rho_t, tau_t, mats = vmem_solver.solve_inputs(xt, lmbd, rho, kt)
        mode = iso_mode if iso else None
        fast = vmem_solver.fast_iterations(precision, 0.75, 100)
        run = lambda: vmem_solver._WholeSolve.apply(hty_, freq, rho_t, tau_t, mode, 100, fast, None, *mats)  # noqa: E731
        plain = lambda: vmem_solver.admm_tv_vmem_plain(hty_, freq, mats, rho_t, tau_t, mode, 100, fast)  # noqa: E731
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = max_diff(got, want)
        log(f"K2 {name} {tuple(xt.shape)} x100 ({len(mats)} matrices): max|diff| {err:.3e} (tol {tol})")
        require(torch.isfinite(got).all(), f"K2 {name}: non-finite output")
        require(err <= tol, f"K2 {name} disagrees: {err}")
        ms = graph_ms(run, 2, 3)
        extra_ms[name] = ms
        log(f"K2 {name}: {ms:.3f} ms (CUDA graph)")
        if name == "sample":
            k2_flagship = (err, ms, graph_ms(plain, 1, 3), hty_.numel(), len(mats))
    err, k2_ms, k2_plain_ms, numel, n_mats = k2_flagship
    h = w = 256
    planes = numel // (h * w)
    products = 2 if n_mats == 2 else 4  # per transform
    flops = 100 * (2 * products * planes * 2 * h * h * w + CHAIN_FLOPS_PER_PIXEL * numel)
    k2_bytes = 2 * numel * 4 + h * w * 4 + n_mats * h * h * 4
    k2 = {"name": "admm_tv_vmem", "route": "cuda",
          "source": "torch_admm_deconv_tpu_torch/csrc/vmem_solver.cu",
          "replaces": "torch_admm_deconv_tpu/kernels/vmem_solver.py:213",
          "max_abs_err": err, "ms": k2_ms, "plain_ms": k2_plain_ms,
          "bound_ms": max(k2_bytes / PEAK_BYTES, flops / PEAK_F32_FLOPS) * 1e3,
          "bound_by": "operations" if flops / PEAK_F32_FLOPS >= k2_bytes / PEAK_BYTES else "bytes",
          "library_ms": None}
    log(f"K2 flagship (1, 3, 256, 256) sample x100: {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms, "
        f"bound {k2['bound_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP)")

    # -- the main path: counts set to 0 just before, read just after ----------
    fused_admm.LAUNCHES.reset()
    vmem_solver.LAUNCHES.reset()

    # phase 4: flagship forward at full width, batch 1, AWGN sigma=15 tile
    gen = torch.Generator().manual_seed(0)
    model = flagship_divergent_restorer(remat=False, use_pallas=True, device=dev, generator=gen).eval()
    scan_model = flagship_divergent_restorer(remat=False, use_pallas=False, device=dev)
    scan_model.load_state_dict(model.state_dict())
    scan_model.eval()
    xt = torch.from_numpy(noisy_tile[None]).to(dev)
    admm_out = {}
    for tag, net in (("kernel", model), ("loop", scan_model)):
        for i in range(2):
            getattr(net.block_0, f"admm_{i}").register_forward_hook(
                lambda mod, inp, out, key=(tag, i): admm_out.__setitem__(key, out))
    times = []
    with torch.inference_mode():
        before = vmem_solver.LAUNCHES.n
        out = model(xt)
        torch.cuda.synchronize()
        require(vmem_solver.LAUNCHES.n - before == 2, "flagship forward must launch K2 twice")
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before = vmem_solver.LAUNCHES.n
            start.record()
            model(xt)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            require(vmem_solver.LAUNCHES.n - before == 2, "flagship forward must launch K2 twice")
        ref = scan_model(xt)
    torch.cuda.synchronize()
    require(out.shape == (1, 3, 256, 256) and torch.isfinite(out).all(), "flagship output malformed")
    # the two ADMM layers: whole-solve cas products against cuFFT in the
    # loop, both float32 exact solves: 1e-4
    admm_err = max(max_diff(admm_out[("kernel", i)], admm_out[("loop", i)]) for i in range(2))
    # the output: CBAM's spatial gate takes a per-pixel mode over channels,
    # which jumps where two channels tie exactly; a 1e-6 change in the ADMM
    # output makes or breaks such a tie, and the gate's InstanceNorm then
    # rescales the whole plane (CPU run of the plain versions at this shape:
    # 3 of 65536 pixels tie, max 6e-3, median 5e-5). Max 2e-2, median 1e-3.
    diff = (out - ref).abs()
    flag_err, flag_med = float(diff.max()), float(diff.median())
    log(f"flagship forward (1, 3, 256, 256): median {statistics.median(times):.3f} ms over {len(times)} "
        f"(CUDA events), K2 launches/forward 2; ADMM layers max|kernel - loop| {admm_err:.3e} (tol 1e-4); "
        f"output max {flag_err:.3e} (tol 2e-2), median {flag_med:.3e} (tol 1e-3)")
    require(admm_err <= 1e-4, f"flagship ADMM layers disagree with the loop path: {admm_err}")
    require(flag_err <= 2e-2 and flag_med <= 1e-3,
            f"flagship kernel path disagrees with the loop path: {flag_err}, {flag_med}")

    # phase 5: classical tiled serving, aniso TV, K2 per batch of 8 tiles
    clean = synthetic_image(rng, 3, 512, 768)
    noisy = clean + rng.normal(0.0, 15.0 / 255.0, clean.shape).astype(np.float32)
    before = vmem_solver.LAUNCHES.n
    t0 = time.perf_counter()
    restored = restore_image(classical_restorer(iso=False, maxit=100, device=dev), noisy,
                             tile=256, margin=32, max_batch=8)
    serve_s = time.perf_counter() - t0
    served = vmem_solver.LAUNCHES.n - before
    p_in, p_out = psnr(noisy, clean), psnr(restored, clean)
    log(f"classical serving 3x512x768: {serve_s:.3f} s, K2 launches {served}, "
        f"PSNR {p_in:.3f} -> {p_out:.3f} dB")
    require(served > 0 and np.isfinite(restored).all() and p_out > p_in, "classical serving failed")

    # phase 6: the solver loop with the fused step (use_pallas with remat)
    with torch.inference_mode():
        before = fused_admm.LAUNCHES.n
        got = admm_tv(xt, 0.05, 1.0, None, iso=True, maxit=100, iso_mode="sample",
                      use_pallas=True, remat=True, device=dev)
        want = admm_tv(xt, 0.05, 1.0, None, iso=True, maxit=100, iso_mode="sample",
                       use_pallas=False, device=dev)
    torch.cuda.synchronize()
    loop_err = max_diff(got, want)
    log(f"solver loop with K1 (1, 3, 256, 256) x100: K1 launches {fused_admm.LAUNCHES.n - before}, "
        f"max|K1 loop - plain loop| {loop_err:.3e} (tol 1e-4)")
    require(loop_err <= 1e-4, f"K1 loop disagrees: {loop_err}")

    launches = {"fused_elementwise_step": fused_admm.LAUNCHES.n, "admm_tv_vmem": vmem_solver.LAUNCHES.n}
    for entry in (k1, k2):
        entry["launches"] = launches[entry["name"]]
        require(entry["launches"] > 0, f"{entry['name']} was not launched on the main path")
    log(json.dumps({"k2_ms_by_case": extra_ms, "flagship_forward_ms": times,
                    "serve_s": serve_s, "psnr_in": p_in, "psnr_out": p_out}))

    # -- phase 7: K3 against its plain version -------------------------------
    psfs = {"gauss": gauss, "motion": motion}
    k3_cases = k3_vs_plain(dev, noisy_tile, psfs)
    # -- phase 8: K4 against its plain version and K2 ------------------------
    k4_cases = k4_vs_plain_and_k2(dev, batch8, psfs)
    k4 = k4_cases.pop("entry")
    k2_batch8 = k4_cases.pop("k2_out")

    # -- the second main path: counts set to 0 just before, read just after --
    for counter in (fused_admm.LAUNCHES, vmem_solver.LAUNCHES, vmem_solver.INTERLEAVED_LAUNCHES,
                    vmem_solver.ADAPTIVE_LAUNCHES):
        counter.reset()
    # phase 8 (main path): the classical serving batch, interleaved schedule
    with torch.inference_mode():
        inter = vmem_solver.admm_tv_vmem(torch.from_numpy(batch8).to(dev), 0.05, 1.0, None,
                                         maxit=100, schedule="interleaved", device=dev)
    torch.cuda.synchronize()
    inter_err = max_diff(inter, k2_batch8)
    log(f"interleaved classical batch (8, 3, 256, 256) x100: K4 launches "
        f"{vmem_solver.INTERLEAVED_LAUNCHES.n}, max|K4 - K2| {inter_err:.3e} (tol 2e-4)")
    require(inter_err <= 2e-4, f"interleaved batch disagrees with K2: {inter_err}")
    # phase 9: the residual-stopped classical solve at full size
    classical = classical_full_size(dev, rng)
    k3 = classical.pop("entry")
    # phase 10: implicit-gradient training
    training = implicit_training(dev, noisy_tile, tile)
    k3["launches"] = vmem_solver.ADAPTIVE_LAUNCHES.n
    k4["launches"] = vmem_solver.INTERLEAVED_LAUNCHES.n
    for entry in (k3, k4):
        require(entry["launches"] > 0, f"{entry['name']} was not launched on the main path")
    log(json.dumps({"k3_cases": k3_cases, "k4_cases": k4_cases, "classical": classical,
                    "training": training}))
    log(json.dumps({"kernels": [k1, k2, k3, k4]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
