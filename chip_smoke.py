"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``torch_admm_deconv_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card (the spatial gates'
channel pool in phase 3b), and drives seven
main paths, each with the launch counts set to 0 just before and read just
after: (1) the flagship DivergentRestorer forward at full width, classical
tiled TV-ADMM serving and the solver loop with the fused step (phases 4-6);
(2) the interleaved classical batch, the residual-stopped classical solve
at full size and implicit-gradient training steps (phases 8-10); (3) the
flagship trained at full width through the port's trainer, its best
checkpoint served through the whole-solve kernel (phase 11); (4) the eval
harness's per-image function with its model, admm and bm3d columns (phase
12), NAFNet at the comparison width and its training script (phase 13),
and the serving script (phase 14); (5) the learned-prox ADMM trained at
full width through the training script, denoising and non-blind
deblurring, each held at init against the whole-solve kernel (phase 15),
then its eval-harness column and the rest of the model zoo, each held
against the CPU (phase 16); (6) the multi-device paths on
``torch.distributed`` with NCCL, one rank a card, each rank a process of
this script in worker mode (``--worker NAME``) under a timeout: the
row-split 4096^2 deblur of ``scripts.megapixel_bench`` in both x-update
modes and its residual-stopped form (phase 17), and data-parallel
learned-prox training through ``scripts.train_dp`` (phase 18); (7) the
classical scripts and the examples: BASELINE config 3's rho/lambda grid
sweep through ``scripts.grid_sweep`` (phase 19), the single-image anchor
with phase 11's checkpoint (phase 20), the mixed-precision study of
``scripts.bench_mixed_precision`` (phase 21), the native C++ loader feeding
the learned prox's training where libpng and libjpeg let it build (phase
22), and the two examples, the megapixel one on the ranks (phase 23). It
checks their outputs and prints one JSON line of kernel numbers and, last,
one JSON status line. Exits non-zero, with no result line, when there is no GPU
or a phase fails.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): float32 outside the tensor cores, the
# tensor cores in TF32 and bf16, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
CHAIN_FLOPS_PER_PIXEL = 25  # differences, shrinkage, dual update, adjoint sum
# K3's chain adds the residuals and their sums, the dual rescale and the
# rebuilt spectrum of the epilogue
ADAPTIVE_CHAIN_FLOPS_PER_PIXEL = 50


# temporary directories that outlive a phase, removed at exit
TEMP_DIRS: list = []


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


def solve_bound(exact_flops: float, fast_flops: float, chain_flops: float, nbytes: float):
    """(bound_ms, bound_by, f32_simt_bound_ms) of a whole solve: the larger
    of its bytes at 3.35 TB/s and the operations it issues at their own
    peaks, three TF32 tensor-core passes per exact (3xTF32) product flop,
    one bf16 pass per fast-phase product flop, and the chain's float32 flops
    at 67 TFLOP/s. The third value is the float32-SIMT bound (every flop at
    67 TFLOP/s), kept for comparison with the earlier SIMT products."""
    t_ops = (3 * exact_flops / PEAK_TF32_FLOPS + fast_flops / PEAK_BF16_FLOPS
             + chain_flops / PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    t_simt = max(t_bytes, (exact_flops + fast_flops + chain_flops) / PEAK_F32_FLOPS)
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes", t_simt * 1e3


def adaptive_bound(iters, g: int, h: int, w: int, n_mats: int, planes_io: int):
    """(bound_ms, bound_by, GFLOP, f32_simt_bound_ms) of a K3 solve: the
    operations of the iterations this run's blocks actually ran, every
    product counted as 3xTF32 (the fast phase of 'mixed' is not observed
    per iteration, so its cheaper bf16 passes are counted as exact),
    against the bytes of reading hty and writing ``planes_io`` - 1 output
    planes per input plane."""
    block_iters = int(np.asarray(iters).sum())
    products = block_iters * g * 2 * transform_flops(h, w, n_mats)
    chain = block_iters * g * ADAPTIVE_CHAIN_FLOPS_PER_PIXEL * h * w
    n_planes = len(iters) * g
    nbytes = planes_io * n_planes * h * w * 4 + (2 * h * w + n_mats * h * h) * 4
    bound_ms, bound_by, simt_ms = solve_bound(products, 0.0, chain, nbytes)
    return bound_ms, bound_by, (products + chain) / 1e9, simt_ms


def fixed_bound(numel: int, h: int, w: int, n_mats: int, maxit: int, fast_iters: int):
    """solve_bound of a K2 or K4 solve of ``numel`` floats of planes."""
    per_iter = numel // (h * w) * 2 * transform_flops(h, w, n_mats)
    nbytes = 2 * numel * 4 + h * w * 4 + n_mats * h * h * 4
    return solve_bound(per_iter * (maxit - fast_iters), per_iter * fast_iters,
                       maxit * CHAIN_FLOPS_PER_PIXEL * numel, nbytes)


def require_share(name: str, ms: float, bound_ms: float) -> float:
    """The share of the bound a measured time reaches; above 1 the bound
    is wrong, and the run fails."""
    share = bound_ms / ms
    require(share <= 1.0, f"{name}: {ms} ms is below its bound {bound_ms} ms")
    return share


def tensor_core_instructions(lib) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) in each kernel of a built
    library, counted in ``cuobjdump --dump-sass``."""
    from torch_admm_deconv_tpu_torch.kernels._build import demangle

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    chunks = re.split(r"\n\s*Function : ", sass)[1:]
    names = demangle([c.split("\n", 1)[0].strip() for c in chunks])
    return {n: len(re.findall(r"\bHG?MMA\.", c)) for n, c in zip(names, chunks)}


def launches_per_solve(solves: dict) -> dict:
    """Device operations of one call of each solve under one torch.profiler
    session (a second session in this script recorded no device events):
    ``solves`` maps a name to its calls at two or more iteration counts,
    each warmed up first. A call's operations are the device events (not
    the card's copies of the labels) whose launching runtime call
    (``cudaLaunchKernel``, ``cudaMemsetAsync``, ..., the same CUPTI
    correlation id) starts inside its labelled range, which ends in a
    synchronize. Both ends are on the host's clock: a device
    event's own start is converted from the card's clock, and near a range's
    edge that conversion has put an operation into the neighbouring call.
    An event whose runtime call was not recorded falls back to its own start.
    Fails unless a solve is one persistent launch, the same number of
    operations at every depth, with no host wait or copy to the host inside."""
    calls = [(f"{name} @ {depth}", fn) for name, by_depth in solves.items()
             for depth, fn in by_depth.items()]
    for _, fn in calls:
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for label, fn in calls:
            with torch.profiler.record_function(label):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    cpu, card = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    runtime = {e.id: e for e in events if e.device_type == cpu and e.name.startswith("cu")}
    # the card's copy of each labelled range is an annotation, not an operation
    labels = {label for label, _ in calls}
    device_ops = [e for e in events if e.device_type == card and e.name not in labels
                  and not getattr(e, "is_user_annotation", False)]
    # an event whose runtime call was not recorded keeps its own start
    launched = {id(e): runtime.get(e.id, e).time_range for e in device_ops}
    log(f"device events timed by their launching runtime call: "
        f"{sum(e.id in runtime for e in device_ops)} of {len(device_ops)}; by their own start: "
        f"{sorted({e.name[:40] for e in device_ops if e.id not in runtime})}")
    per_call = {}
    for label, _ in calls:
        rng = next(e.time_range for e in events if e.name == label)
        inside = lambda t: rng.start <= t.start <= rng.end  # noqa: E731, B023
        on_card = [e for e in device_ops if inside(launched[id(e)])]
        waits = sum(e.device_type == cpu and inside(e.time_range)
                    and e.name in ("cudaEventSynchronize", "cudaStreamSynchronize")
                    for e in events)
        per_call[label] = (len(on_card), sum("persistent" in e.name for e in on_card), waits,
                           sum("DtoH" in e.name for e in on_card), [e.name[:40] for e in on_card])
    out = {}
    for name, by_depth in solves.items():
        counts = [per_call[f"{name} @ {depth}"] for depth in by_depth]
        log(f"{name}: device operations per solve {[c[0] for c in counts]} at maxit "
            f"{list(by_depth)} (persistent launches {[c[1] for c in counts]}, host waits "
            f"{[c[2] for c in counts]}, copies to the host {[c[3] for c in counts]}; "
            f"torch.profiler)")
        require(len({c[0] for c in counts}) == 1,
                f"{name}: device operations grow with maxit: {[c[4] for c in counts]}")
        require(all(c[1] == 1 for c in counts), f"{name}: not one persistent launch per solve")
        require(all(c[2] == 0 and c[3] == 0 for c in counts),
                f"{name}: the host waits inside a solve")
        out[name] = counts[0][0]
    return out


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
        # 3xTF32 tensor-core products against cuBLAS f32: 2e-4 (the K2
        # bar); 'mixed' rounds operands to bf16, where a one-ulp flip between
        # the two summation orders survives the exact tail: 2e-3
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
            bound_ms, bound_by, gflop, simt_ms = adaptive_bound(iters_k, cfg.g, *xt.shape[-2:],
                                                                len(mats), 6 if state else 2)
            share = require_share(f"K3 {name}", ms, bound_ms)
            log(f"K3 {name} tol {tol} (max {maxit}): iters {iters_k.tolist()} / plain "
                f"{iters_p.tolist()}, max r {float(r.max()):.3e} s {float(sd.max()):.3e}, "
                f"rho {rho_f.tolist()}, max|diff| {err:.3e}; {ms:.3f} ms (CUDA events), plain "
                f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}, {gflop:.2f} GFLOP; "
                f"{share:.1%} of it), f32 SIMT bound {simt_ms:.4f} ms")
            require(bool(done.all()) and bool(done_p.all()),
                    f"K3 {name}: a block stopped before reaching tol")
            require(int(gap.max()) <= 1, f"K3 {name}: iteration counts differ by more than 1")
            out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "bound_f32_simt_ms": simt_ms,
                         "library_ms": None, "iters": iters_k.tolist(),
                         "max_abs_err": err,
                         "launches": vmem_solver.ADAPTIVE_LAUNCHES.n - launched}
    return out


def k4_vs_plain_and_k2(dev, batch8, psfs):
    """Phase 8: K4 against its plain version and against K2: five cases at
    (8, 3, 256, 256) x100, a ragged (2, 3, 250, 190) batch, a 512^2 plane
    (its state in L2) and one iteration; each timed beside K2."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver

    local = np.random.default_rng(8)  # the extra shapes' images; rng stays as it was
    ragged = np.stack([synthetic_image(local, 3, 250, 190) for _ in range(2)])
    big = synthetic_image(local, 3, 512, 512)[None]
    cases = [
        # name, images, iso, psf, precision, maxit
        ("aniso", batch8, False, None, "high", 100),
        ("joint", batch8, True, None, "high", 100),
        ("aniso_motion9", batch8, False, "motion", "high", 100),
        ("aniso_mixed", batch8, False, None, "mixed", 100),
        ("joint_mixed", batch8, True, None, "mixed", 100),
        ("aniso_250x190", ragged, False, None, "high", 100),
        ("aniso_512", big, False, None, "high", 100),
        ("aniso_maxit1", batch8, False, None, "high", 1),
    ]
    out = {}
    for name, images, iso, psf, precision, maxit in cases:
        xb = torch.from_numpy(np.ascontiguousarray(images)).to(dev)
        kern = None if psf is None else torch.from_numpy(psfs[psf]).to(dev)
        lmbd, rho = (0.05, 1.0) if psf is None else (0.01, 1.0)
        hty, freq, rho_t, tau_t, mats = vmem_solver.solve_inputs(xb, lmbd, rho, kern)
        mode = "joint" if iso else None
        fast = vmem_solver.fast_iterations(precision, 0.75, maxit)
        pack = vmem_solver._fixed_pack(xb.shape, iso, "joint")
        k4 = lambda: vmem_solver._WholeSolve.apply(hty, freq, rho_t, tau_t, mode, maxit, fast, pack, *mats)  # noqa: E731, B023
        k2 = lambda: vmem_solver._WholeSolve.apply(hty, freq, rho_t, tau_t, mode, maxit, fast, None, *mats)  # noqa: E731, B023
        plain = lambda: vmem_solver.admm_tv_vmem_interleaved_plain(hty, freq, mats, rho_t, tau_t, mode, maxit, fast)  # noqa: E731, B023
        got, want, batched = k4(), plain(), k2()
        torch.cuda.synchronize()
        err, err_k2 = max_diff(got, want), max_diff(got, batched)
        # the K2 bars: 2e-4 'high', 2e-3 'mixed'; against K2 in 'high' the
        # JAX test's 2e-4 (tests/test_vmem_solver.py:170-198). In 'mixed' the
        # left-first transform rounds at other points than K2's: printed only
        x_tol = 2e-4 if precision == "high" else 2e-3
        require(got.shape == xb.shape and torch.isfinite(got).all(), f"K4 {name}: malformed output")
        require(err <= x_tol, f"K4 {name} disagrees with its plain version: {err}")
        if precision == "high":
            require(err_k2 <= 2e-4, f"K4 {name} disagrees with K2: {err_k2}")
        ms, k2_ms = cuda_ms(k4, 3), cuda_ms(k2, 3)
        log(f"K4 {name} {tuple(xb.shape)} x{maxit} pack {pack} ({len(mats)} matrices): max|diff| "
            f"plain {err:.3e} (tol {x_tol}), K2 {err_k2:.3e}; K4 {ms:.3f} ms, K2 {k2_ms:.3f} ms "
            f"(CUDA events)")
        out[name] = {"ms": ms, "k2_ms": k2_ms, "max_abs_err": err, "err_vs_k2": err_k2}
        if name == "aniso":
            bound_ms, bound_by, simt_ms = fixed_bound(xb.numel(), 256, 256, len(mats), 100, fast)
            share = require_share("K4", ms, bound_ms)
            log(f"K4 aniso bound {bound_ms:.4f} ms ({bound_by}; {share:.1%} of it), f32 SIMT "
                f"bound {simt_ms:.4f} ms")
            out["entry"] = {
                "name": "admm_tv_vmem_interleaved", "route": "cuda",
                "source": "torch_admm_deconv_tpu_torch/csrc/vmem_interleaved.cu",
                "replaces": "torch_admm_deconv_tpu/kernels/vmem_solver.py:134",
                "max_abs_err": err, "ms": ms, "plain_ms": cuda_ms(plain, 1),
                "bound_ms": bound_ms, "bound_by": bound_by, "bound_f32_simt_ms": simt_ms,
                "library_ms": None}
            out["k2_out"] = batched
            out["k4_calls"] = {depth: (lambda depth=depth: vmem_solver._WholeSolve.apply(  # noqa: B023
                hty, freq, rho_t, tau_t, mode, depth, 0, pack, *mats)) for depth in (10, 100)}
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
        bound_ms, bound_by, gflop, simt_ms = adaptive_bound(iters, 1, 512, 512, 2, 2)
        share = require_share(f"K3 classical {precision}", ms, bound_ms)
        log(f"K3 classical (8, 3, 512, 512) {precision}: {ms:.3f} ms (CUDA events), iters "
            f"{iters.tolist()} (sum {int(iters.sum())}; the loop {int(loop.iters)} x 24 planes), "
            f"max r {r_max:.3e} s {s_max:.3e} (tol 1e-5), PSNR {p_in:.3f} -> {p_out:.3f} dB, "
            f"max|K3 - loop| {loop_err:.3e} (tol 5e-3), bound {bound_ms:.3f} ms ({bound_by}, "
            f"{gflop:.1f} GFLOP; {share:.1%} of it), f32 SIMT bound {simt_ms:.3f} ms")
        require(torch.isfinite(res.x).all(), f"K3 classical {precision}: non-finite output")
        require(r_max <= 1e-5 and s_max <= 1e-5, f"K3 classical {precision}: residuals above tol")
        require(p_out > p_in, f"K3 classical {precision}: no PSNR gain")
        # per-block stopping here, global stopping in the loop: the JAX
        # test's bar (tests/test_vmem_solver.py:130)
        require(loop_err <= 5e-3, f"K3 classical {precision} disagrees with the loop: {loop_err}")
        out[precision] = {"ms": ms, "iters": iters.tolist(), "r_max": r_max, "s_max": s_max,
                          "psnr_out": p_out, "err_vs_loop": loop_err, "bound_ms": bound_ms,
                          "bound_f32_simt_ms": simt_ms}
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
            # how far rounding alone moves the stopping iteration here: the
            # plain version with float64 products against the float32 one.
            # K3's products (3xTF32) round otherwise than cuBLAS's float32,
            # so K3 is held to stop no farther from the float64 reference
            # than the float32 plain version does (and within 1 where that
            # one matches it)
            xform = vmem_solver._xform
            vmem_solver._xform = lambda v, m, fast: xform(v.double(), [q.double() for q in m],
                                                          False).float()
            try:
                ref = vmem_solver.admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lr, cfg)
            finally:
                vmem_solver._xform = xform
            ref_gap = int((want[5] - ref[5]).abs().max())
            ref_gap_k3 = int((iters - ref[5].cpu()).abs().max())
            log(f"K3 classical high vs plain: max|diff| {err:.3e} (tol 2e-4), iters differ by at "
                f"most {gap}; plain {plain_ms:.3f} ms. Rounding alone: the plain version with "
                f"float64 products stops up to {ref_gap} iterations from the float32 one (K3: "
                f"{ref_gap_k3}), max|diff| {max_diff(want[0], ref[0]):.3e}")
            require(err <= 2e-4, f"K3 classical disagrees with its plain version: {err}")
            require(ref_gap_k3 <= max(1, ref_gap),
                    f"K3 classical stops {ref_gap_k3} iterations from the float64 reference, "
                    f"the float32 plain version {ref_gap}")
            out["iteration_gaps"] = {"k3_vs_plain": gap, "plain_vs_f64_products": ref_gap,
                                     "k3_vs_f64_products": ref_gap_k3}
            out["entry"] = {
                "name": "admm_tv_adaptive_vmem", "route": "cuda",
                "source": "torch_admm_deconv_tpu_torch/csrc/vmem_adaptive.cu",
                "replaces": "torch_admm_deconv_tpu/kernels/vmem_solver.py:505",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_f32_simt_ms": simt_ms, "library_ms": None}
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

    # host-bound steps whose time varies up to 2x from one step to the next
    # on a shared host: the median of 5 after a warm-up (first-call costs of
    # the FFT plans and autograd), with the range
    layer_step()
    steps = [layer_step() for _ in range(5)]
    x = steps[-1][0]
    fwd = [f for _, f, _ in steps]
    bwd = [b for _, _, b in steps]
    fwd_s, bwd_s = statistics.median(fwd), statistics.median(bwd)
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
        f"{res.iters.tolist()}; warm steps (median of 5, min-max) forward {fwd_s:.4f} s "
        f"[{min(fwd):.4f}, {max(fwd):.4f}], backward {bwd_s:.4f} s [{min(bwd):.4f}, "
        f"{max(bwd):.4f}]; exit "
        f"state max|K3 - loop| {state_err:.3e} (tol 1e-3); gradients against the loop state's: "
        f"xin rel L2 {err_x:.3e} (max_rel {max_x:.3e}), lambda rel {err_l:.3e} "
        f"({float(got[1]):.6e} vs {float(ref[1]):.6e}), rho {err_r:.3e} of lambda's "
        f"({float(got[2]):.3e} vs {float(ref[2]):.3e}) (tol 1e-2)")
    require(state_err <= 1e-3, f"implicit layer: K3 exit state disagrees with the loop: {state_err}")
    require(max(err_x, err_l, err_r) <= 1e-2, "implicit layer: gradients disagree with the loop's")
    out["layer_forward_s"], out["layer_backward_s"] = fwd_s, bwd_s
    out["layer_forward_samples_s"], out["layer_backward_samples_s"] = fwd, bwd

    # (b) the flagship at full width, the train.py --gradient_mode implicit path
    model = flagship_divergent_restorer(gradient_mode="implicit", device=dev,
                                        generator=torch.Generator().manual_seed(0))
    times = []
    for _ in range(6):  # a warm-up step, then 5 timed ones
        model.zero_grad()
        t0 = time.perf_counter()
        loss = torch.mean((model(xin) - clean) ** 2)
        loss.backward()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    flag_s = statistics.median(times[1:])
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads)
    nonzero = sum(bool(gr.abs().max() > 0) for gr in grads)
    log(f"implicit flagship (1, 3, 256, 256): forward+backward {flag_s:.3f} s (median of 5, "
        f"[{min(times[1:]):.3f}, {max(times[1:]):.3f}]; first step {times[0]:.3f} s), loss "
        f"{float(loss.detach()):.6f}, {len(grads)} parameter gradients, {nonzero} nonzero, finite {finite}")
    require(bool(torch.isfinite(loss)) and finite and nonzero > 0,
            "implicit flagship: gradients not finite or all zero")
    out["flagship_s"], out["flagship_samples_s"] = flag_s, times[1:]
    return out


class SyntheticPairs:
    """An in-memory stand-in for ``ImageDataset``, which reads image files
    with PIL (not needed here) from a corpus the repo does not hold: clean
    synthetic images in [0, 255] as both x and y, through the same paired
    transforms, read by ``DataLoader`` through ``get(idx, rng)``."""

    def __init__(self, images, transforms):
        self.images, self.transforms = images, transforms

    def __len__(self) -> int:
        return len(self.images)

    def get(self, idx: int, rng: np.random.Generator):
        x = y = self.images[idx]
        for t in self.transforms:
            x, y = t(x, y, rng)
        return x, y


# configs/train_cfg.json's batch sizes: batch 3 at 256^2 fits the card (at
# most 27.6 GiB allocated over two epochs on an H100 80GB), so no accumulation
TRAIN_BATCH, ACCUM_STEPS, EVAL_BATCH = 3, 1, 8
# the fixed-batch steps' LR: 1/100 of the training LR, where a step is a
# first-order descent step (at the training LR itself 4 steps raised the
# fixed batch's loss 0.179 -> 0.214 on an H100, two epochs in; the port's
# trainer takes the JAX trainer's steps at that LR, to 4e-8 in float64:
# tests/test_torch_fixed_batch_lr.py)
FIXED_LR = 8.8e-6


def flagship_training(dev, rng):
    """Phase 11: the flagship trained at full width, as
    ``scripts/train.py`` trains it: DivergentRestorer [2, 8, 32] / 86 filters,
    two unrolled 100-iteration 'compat' ADMM layers under remat,
    SSIMLabColorLoss, AdamW, the warm-restart schedule, the strictly-best
    saver, AWGN sigma in [0, 15)/255 added on the fly to 256^2 crops of
    3x320x320 synthetic images (6 train, 8 eval) for 2 epochs; then 4 steps
    on one fixed batch at ``FIXED_LR``; then the best checkpoint served at
    batch 1 through K2 (``model_restorer``)."""
    from torch_admm_deconv_tpu_torch.data import AddAWGN, DataLoader, RandCrop, Scale
    from torch_admm_deconv_tpu_torch.infer import model_restorer
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver
    from torch_admm_deconv_tpu_torch.metrics import (
        MAELoss,
        PSNRMetric,
        SCCMetric,
        SSIMLabColorLoss,
        SSIMMetric,
        UIQMetric,
        functional,
        ssim,
    )
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer
    from torch_admm_deconv_tpu_torch.train import (
        MetricsLogger,
        NNSaver,
        NNTrainer,
        cosine_annealing_warm_restarts,
        load_checkpoint,
        make_optimizer,
    )

    transforms = [RandCrop((256, 256)), Scale(), AddAWGN(std_range=(0, 15))]
    images = [synthetic_image(rng, 3, 320, 320) * 255.0 for _ in range(14)]
    train_loader = DataLoader(SyntheticPairs(images[:6], transforms), TRAIN_BATCH, seed=0)
    eval_loader = DataLoader(SyntheticPairs(images[6:], transforms), EVAL_BATCH, seed=1)
    fixed = [next(iter(train_loader))]

    loss = SSIMLabColorLoss()
    metrics = [PSNRMetric(), SCCMetric(), SSIMMetric(), MAELoss(), UIQMetric()]
    logger = MetricsLogger(loss, metrics)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    saver = NNSaver(out_dir, "flagship")
    trainer = NNTrainer(loss, metrics, saver, logger, skip_nonfinite_updates=True,
                        on_nonfinite="raise", accum_steps=ACCUM_STEPS)
    lr = 8.8e-4
    sched = cosine_annealing_warm_restarts(lr, 15000, eta_min=1e-11)
    model = flagship_divergent_restorer(device=dev, generator=torch.Generator().manual_seed(0))

    # every step ends in a synchronize here, so the host clock times it;
    # the peak of device memory allocated during each step, by kind
    times = {"train": [], "eval": []}
    peaks = {"train": 0, "eval": 0}

    def timed(fn, key):
        def step(*args):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            times[key].append(time.perf_counter() - t0)
            peaks[key] = max(peaks[key], torch.cuda.max_memory_allocated())
            return out
        return step

    trainer._train_step = timed(trainer._train_step, "train")
    trainer._train_step_accum = timed(trainer._train_step_accum, "train")
    trainer._eval_step = timed(trainer._eval_step, "eval")
    log_buf = io.StringIO()  # the parameter table and epoch lines: a summary is printed
    with contextlib.redirect_stdout(log_buf):
        trainer.run(model, make_optimizer(lr), 2, train_loader, eval_loader,
                    lr_scheduler=sched, base_lr=lr)
        epochs = {k: list(v) for k, v in logger.get_logged().items() if v}
        fixed_losses = []  # the loss before each of the 4 steps, then after the last
        for _ in range(4):
            trainer.train(fixed, lambda step: FIXED_LR)
            fixed_losses.append(logger.get_avg_metrics("train")[loss.m_name])
        trainer.eval(fixed)
        fixed_losses.append(logger.get_avg_metrics("eval")[loss.m_name])
    steps, warm = times["train"], times["train"][1:]  # 2 epochs' steps, then the fixed 4
    evals = times["eval"][:2]  # the epochs' eval steps (the fixed-batch one comes after)
    lam_rho = {n: float(p.detach()) for n, p in model.named_parameters()
               if n.rsplit(".", 1)[-1] in ("lmbda", "rho")}
    log(f"flagship training (batch {TRAIN_BATCH} x accum {ACCUM_STEPS}, 256^2): "
        f"{len(steps) - 4} steps in 2 epochs and 4 on a fixed batch, warm steps (median of "
        f"{len(warm)}, min-max) {statistics.median(warm):.3f} s [{min(warm):.3f}, "
        f"{max(warm):.3f}] (first {steps[0]:.3f} s), eval steps (batch {EVAL_BATCH}) "
        f"{[round(t, 3) for t in evals]} s, peak memory of a train step "
        f"{peaks['train'] / 2**30:.2f} GiB, of an eval step {peaks['eval'] / 2**30:.2f} GiB; "
        f"epoch losses train {epochs['train_color_lab_loss']} eval "
        f"{epochs['eval_color_lab_loss']}, eval PSNR {epochs['eval_psnr']}; fixed batch "
        f"loss at lr {FIXED_LR} {[round(v, 6) for v in fixed_losses]}; skipped "
        f"updates {trainer.skipped_updates}; lambda/rho {lam_rho}")
    require(trainer.skipped_updates == 0, "flagship training skipped an update")
    require(all(math.isfinite(v) for vals in epochs.values() for v in vals)
            and all(math.isfinite(v) for v in fixed_losses), "flagship training: non-finite")
    require(fixed_losses[-1] < fixed_losses[0], "flagship training: the fixed-batch loss did not fall")
    require(all(1e-12 <= v <= 5.0 for v in lam_rho.values()),
            "flagship training: lambda or rho left [1e-12, 5]")

    # the loss's SSIM windows run in float32 whatever the TF32 flags say
    with torch.no_grad():
        pred = model(torch.from_numpy(fixed[0][0]).to(dev))
        target = torch.from_numpy(fixed[0][1]).to(dev)
        ssim_off = float(ssim(pred, target))
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ssim_on = float(ssim(pred, target))
            # for scale: the windowed variance E[x^2] - mu^2 of the output by a
            # plain grouped conv (unguarded, TF32 on) against the guarded one
            k = torch.exp(-((torch.arange(11, device=dev) - 5.0) ** 2) / (2 * 1.5**2))
            k = k / k.sum()
            w2 = (k[:, None] * k[None, :]).expand(3, 1, 11, 11).contiguous()
            raw = [torch.nn.functional.conv2d(v, w2, groups=3) for v in (pred * pred, pred)]
            var_tf32 = raw[0] - raw[1] ** 2
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        mu_xx, mu_x = (functional._windowed_means(v, k) for v in (pred * pred, pred))
        var_f32 = mu_xx - mu_x**2
        var_gap = float((var_tf32 - var_f32).abs().max())
    ssim_gap = abs(ssim_on - ssim_off)
    log(f"SSIM of the trained output (3, 3, 256, 256): TF32 off {ssim_off:.8f}, on {ssim_on:.8f}, "
        f"|diff| {ssim_gap:.3e} (tol 1e-5); for scale, window variances by an unguarded "
        f"grouped conv with TF32 on differ from the guarded float32 ones by up to {var_gap:.3e} "
        f"(smallest {float(var_tf32.min()):.3e} / {float(var_f32.min()):.3e})")
    require(ssim_gap <= 1e-5, f"SSIM depends on the TF32 flags: {ssim_gap}")

    # the best checkpoint, served at batch 1 through K2, against the loop
    best = sorted(saver.model_saving_path.parent.glob("*.tar"))[-1]
    state = load_checkpoint(best, map_location=dev)["model_state_dict"]
    served = flagship_divergent_restorer(remat=False, use_pallas=True, device=dev)
    loop = flagship_divergent_restorer(remat=False, use_pallas=False, device=dev)
    loop.load_state_dict(state)
    loop.eval()
    admm_out = {}
    for tag, net in (("kernel", served), ("loop", loop)):
        for i in range(2):
            getattr(net.block_0, f"admm_{i}").register_forward_hook(
                lambda mod, inp, out, key=(tag, i): admm_out.__setitem__(key, out))
    tile = fixed[0][0][:1]
    before = vmem_solver.LAUNCHES.n
    restored = model_restorer(state, model=served, device=dev)(tile)
    k2_served = vmem_solver.LAUNCHES.n - before
    with torch.inference_mode():
        loop_out = loop(torch.from_numpy(tile).to(dev)).cpu().numpy()
    admm_err = max(max_diff(admm_out[("kernel", i)], admm_out[("loop", i)]) for i in range(2))
    out_err = float(np.abs(restored - loop_out).max())
    log(f"best checkpoint {best.name} served (1, 3, 256, 256): K2 launches {k2_served}, ADMM "
        f"layers max|kernel - loop| {admm_err:.3e} (tol 1e-4), output max {out_err:.3e}")
    require(k2_served == 2, f"the served checkpoint must launch K2 twice, launched {k2_served}")
    require(restored.shape == (1, 3, 256, 256) and np.isfinite(restored).all(),
            "served checkpoint output malformed")
    require(admm_err <= 1e-4, f"served checkpoint: ADMM layers disagree with the loop: {admm_err}")
    return {"best_checkpoint": str(best), "checkpoint_dir": out_dir,
            "batch": TRAIN_BATCH, "accum_steps": ACCUM_STEPS, "image": [3, 256, 256],
            "step_s_median": statistics.median(warm), "step_s": steps,
            "eval_step_s": evals, "peak_memory_bytes": peaks,
            "fixed_batch_loss": fixed_losses, "epochs": epochs, "lambda_rho": lam_rho,
            "ssim_tf32_off": ssim_off, "ssim_tf32_on": ssim_on,
            "unguarded_tf32_variance_gap": var_gap, "served_k2_launches": k2_served,
            "served_admm_err": admm_err, "served_output_err": out_err,
            "trainer_log_tail": log_buf.getvalue().strip().splitlines()[-3:]}


# scripts/eval_algs.py at its defaults: 256^2 crops, AWGN sigma in [15, 16),
# lambda 0.05, rho 1, 100 iterations; the deblur protocol with a 9x9
# Gaussian of sigma 1.5. Synthetic 3x320x320 images (the card's machine has
# no PIL and the repo no corpus); BM3D, NumPy on the host (5 s an image on
# one core), on the first image only
EVAL_IMAGES = 4
EVAL_LMBD, EVAL_RHO, EVAL_MAXIT = 0.05, 1.0, 100


def eval_harness(dev, rng, ckpt):
    """Phase 12: the eval harness's per-image function
    (``scripts.eval_algs.evaluate_pair``) over ``EVAL_IMAGES`` synthetic
    images at batch 1, its model column from ``ckpt`` (K2 twice an image),
    its admm column denoising (K2 'sample') and deblurring (K2 aniso, cas
    transform), its bm3d column on one image; the admm outputs and the
    model's ADMM layers against the FFT loop on the card."""
    from torch_admm_deconv_tpu_torch.data import (
        AddAWGN,
        CircBlur,
        DataLoader,
        RandCrop,
        Scale,
        gaussian_psf_np,
    )
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv
    from torch_admm_deconv_tpu_torch.scripts import eval_algs

    images = [synthetic_image(rng, 3, 320, 320) * 255.0 for _ in range(EVAL_IMAGES)]
    psf = gaussian_psf_np(9, 1.5)
    kern = torch.from_numpy(psf.reshape(1, 1, 9, 9)).to(dev)
    awgn = AddAWGN(std_range=(15, 16))
    protocols = {
        "denoise": ([RandCrop(256), Scale(), awgn], None),
        "deblur": ([RandCrop(256), Scale(), CircBlur(psf), awgn], psf),
    }
    model = eval_algs.model_column(ckpt, device=dev)
    loop_model = flagship_divergent_restorer(remat=False, use_pallas=False, device=dev)
    loop_model.load_state_dict(model.state_dict())
    loop_model.eval()
    layers = {}
    for tag, net in (("kernel", model), ("loop", loop_model)):
        for i in range(2):
            getattr(net.block_0, f"admm_{i}").register_forward_hook(
                lambda mod, inp, out, key=(tag, i): layers.__setitem__(key, out))

    result = {}
    for protocol, (transforms, p) in protocols.items():
        loader = DataLoader(SyntheticPairs(images, transforms), 1, shuffle=False, seed=0,
                            drop_last=False)
        columns = {"admm": eval_algs.admm_column(EVAL_LMBD, EVAL_RHO, EVAL_MAXIT, p, device=dev)}
        if p is None:
            columns = {"model": model, **columns}
        rows, seconds, noisy_psnr = [], {}, []
        admm_err = layer_err = 0.0
        for i, (x, y) in enumerate(loader):
            cols = dict(columns, bm3d=eval_algs.bm3d_column) if p is None and i == 0 else columns
            outs, image_rows, secs = eval_algs.evaluate_pair(x, y, cols, device=dev)
            rows += [{"image": i, **r} for r in image_rows]
            for name, sec in secs.items():
                seconds.setdefault(name, []).append(sec)
            noisy_psnr.append(psnr(x, y))
            xt = torch.from_numpy(x).to(dev)
            with torch.inference_mode():
                loop = admm_tv(xt, EVAL_LMBD, EVAL_RHO, None if p is None else kern,
                               iso=p is None, maxit=EVAL_MAXIT, use_pallas=False, device=dev)
                if p is None:
                    loop_model(xt)
                    layer_err = max(layer_err, *(max_diff(layers[("kernel", j)], layers[("loop", j)])
                                                 for j in range(2)))
            admm_err = max(admm_err, float(np.abs(outs["admm"] - loop.cpu().numpy()).max()))
            require(all(np.isfinite(o).all() and o.shape == x.shape for o in outs.values()),
                    f"eval harness {protocol}: output malformed")
        mean_psnr = {m: float(np.mean([r["psnr"] for r in rows if r["method"] == m]))
                     for m in seconds}
        s_per_image = {m: statistics.mean(v) for m, v in seconds.items()}
        for line in eval_algs.summary(rows, sum(s_per_image.values())):
            log(f"eval harness {protocol}: {line}")
        log(f"eval harness {protocol} ({len(noisy_psnr)} images of 3x256x256): s/image by column "
            f"{ {m: round(v, 4) for m, v in s_per_image.items()} } (each image's "
            f"{ {m: [round(t, 4) for t in v] for m, v in seconds.items()} }); mean PSNR noisy "
            f"{np.mean(noisy_psnr):.3f} dB, by column {mean_psnr}; admm max|kernel - loop| "
            f"{admm_err:.3e} (tol 1e-4)" + (f", model ADMM layers max|kernel - loop| "
                                            f"{layer_err:.3e} (tol 1e-4)" if p is None else ""))
        require(admm_err <= 1e-4, f"eval harness {protocol}: admm column disagrees with the "
                                  f"loop: {admm_err}")
        require(layer_err <= 1e-4, f"eval harness: model ADMM layers disagree with the loop: "
                                   f"{layer_err}")
        require(mean_psnr["admm"] > np.mean(noisy_psnr), f"eval harness {protocol}: admm column "
                                                          "gains no PSNR")
        if "bm3d" in mean_psnr:
            require(mean_psnr["bm3d"] > noisy_psnr[0], "eval harness: bm3d gains no PSNR")
        result[protocol] = {"rows": rows, "seconds": seconds, "s_per_image": s_per_image,
                            "noisy_psnr": noisy_psnr, "mean_psnr": mean_psnr,
                            "admm_err_vs_loop": admm_err, "model_layer_err_vs_loop": layer_err}
    return result


def _timed_train_steps(times, peaks):
    """Patch ``NNTrainer._train_step`` to time each step (host clock ending
    in a synchronize) and its peak device memory; returns the undo."""
    from torch_admm_deconv_tpu_torch.train import NNTrainer

    step = NNTrainer._train_step

    def timed(self, *args):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(self, *args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())

    NNTrainer._train_step = timed
    return lambda: setattr(NNTrainer, "_train_step", step)


NAFNET_W64 = dict(img_channel=3, width=64, middle_blk_num=12, enc_blk_nums=(2, 2, 4, 8),
                  dec_blk_nums=(2, 2, 2, 2))  # the eval harness's comparison configuration


def nafnet(dev, rng):
    """Phase 13: NAFNet w64 forward at (1, 3, 256, 256) against the same
    weights on the CPU (TF32 off), its time and peak memory; then
    ``scripts.train``'s NAFNet (``--arch nafnet``, width 32) trained for 2
    steps at batch 4 on synthetic images."""
    from torch_admm_deconv_tpu_torch.data import AddAWGN, DataLoader, RandCrop, Scale
    from torch_admm_deconv_tpu_torch.models.nafnet import NAFNet
    from torch_admm_deconv_tpu_torch.scripts.train import build_model, run_training
    from torch_admm_deconv_tpu_torch.train import NNSaver

    gen = torch.Generator().manual_seed(0)
    cpu_model = NAFNet(**NAFNET_W64, device="cpu", generator=gen).eval()
    with torch.no_grad():
        # at their zero init every block is the identity
        for name, p in cpu_model.named_parameters():
            if name.rsplit(".", 1)[-1] in ("beta", "gamma"):
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
    x = torch.rand((1, 3, 256, 256), generator=gen)
    model = NAFNet(**NAFNET_W64, device=dev)
    model.load_state_dict(cpu_model.state_dict())
    model.eval()
    xt = x.to(dev)
    times = []
    with torch.inference_mode():
        model(xt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = model(xt)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated()
        want = cpu_model(x)
    err = float((out.cpu() - want).abs().max())
    n_params = sum(p.numel() for p in model.parameters())
    log(f"NAFNet w64 [2,2,4,8]/12/[2,2,2,2] ({n_params} parameters) forward (1, 3, 256, 256): "
        f"median {statistics.median(times):.3f} ms over 5 {[round(t, 3) for t in times]} (CUDA "
        f"events), peak memory allocated {peak / 2**30:.3f} GiB (weights and input "
        f"{base / 2**30:.3f}); max|card - CPU| {err:.3e} (tol 1e-4, TF32 off), max|out - in| "
        f"{float((want - x).abs().max()):.3f}")
    require(torch.isfinite(out).all() and out.shape == xt.shape, "NAFNet output malformed")
    require(err <= 1e-4, f"NAFNet forward on the card disagrees with the CPU: {err}")

    # the training script's model and trainer, on synthetic images
    transforms = [RandCrop((256, 256)), Scale(), AddAWGN(std_range=(0, 15))]
    images = [synthetic_image(rng, 3, 320, 320) * 255.0 for _ in range(12)]
    train_loader = DataLoader(SyntheticPairs(images[:8], transforms), 4, seed=0)
    eval_loader = DataLoader(SyntheticPairs(images[8:], transforms), 4, seed=1)
    net = build_model("nafnet", nafnet_width=32, device=dev,
                      generator=torch.Generator().manual_seed(0))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_nafnet_")
    step_s, step_peak = [], []
    undo = _timed_train_steps(step_s, step_peak)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            trainer = run_training(net, train_loader, eval_loader, 8.8e-4, 1,
                                   NNSaver(out_dir, "nafnet"))
    finally:
        undo()
        shutil.rmtree(out_dir, ignore_errors=True)
    logged = {k: v for k, v in trainer.logger.get_logged().items() if v}
    log(f"NAFNet w32 training (scripts.train --arch nafnet, batch 4, 256^2): {len(step_s)} steps "
        f"{[round(t, 3) for t in step_s]} s, peak memory {max(step_peak) / 2**30:.3f} GiB; train "
        f"loss {logged['train_color_lab_loss']}, eval loss {logged['eval_color_lab_loss']}; "
        f"skipped updates {trainer.skipped_updates}")
    require(len(step_s) == 2, f"NAFNet training ran {len(step_s)} steps, not 2")
    require(trainer.skipped_updates == 0, "NAFNet training skipped an update")
    require(all(math.isfinite(v) for vals in logged.values() for v in vals),
            "NAFNet training: non-finite")
    return {"forward_ms": times, "peak_memory_bytes": peak, "weights_bytes": base,
            "parameters": n_params, "err_vs_cpu": err, "train_step_s": step_s,
            "train_peak_memory_bytes": step_peak, "train_logged": logged}


def serving_script(dev, rng):
    """Phase 14: ``scripts.infer``'s restorer and tiler on a 3x512x768 image
    with AWGN sigma 15: ``--aniso`` (K2 at batch 8) and the default
    isotropic 'compat' TV (the FFT loop), each with the path it reports
    against the launches counted."""
    from torch_admm_deconv_tpu_torch.kernels import fused_admm, vmem_solver
    from torch_admm_deconv_tpu_torch.scripts import infer as infer_script

    clean = synthetic_image(rng, 3, 512, 768)
    noisy = clean + rng.normal(0.0, 15.0 / 255.0, clean.shape).astype(np.float32)
    p_in = psnr(noisy, clean)
    result = {"psnr_in": p_in}
    for name, flags, want in (("aniso", ["--aniso"], "K2 (aniso)"), ("default", [], "FFT loop")):
        args = infer_script.build_parser().parse_args(["--input", "-", "--output", "-", *flags])
        apply_fn, path = infer_script.restorer(args, dev)
        k1, k2 = fused_admm.LAUNCHES.n, vmem_solver.LAUNCHES.n
        t0 = time.perf_counter()
        restored, batches = infer_script.serve(noisy, apply_fn, path, args)
        serve_s = time.perf_counter() - t0
        k1, k2 = fused_admm.LAUNCHES.n - k1, vmem_solver.LAUNCHES.n - k2
        p_out = psnr(restored, clean)
        log(f"serving script {name} ({' '.join(flags) or 'no flags'}) 3x512x768: {serve_s:.3f} s, "
            f"batches {batches}, K2 launches {k2}, K1 launches {k1}, PSNR {p_in:.3f} -> "
            f"{p_out:.3f} dB")
        require(np.isfinite(restored).all() and p_out > p_in, f"serving script {name} failed")
        require(batches and all(b == want for b in batches),
                f"serving script {name}: reported {batches}, expected {want}")
        require(k2 == (len(batches) if want.startswith("K2") else 0) and k1 == 0,
                f"serving script {name}: {k2} K2 and {k1} K1 launches for {batches}")
        result[name] = {"s": serve_s, "batches": batches, "k2_launches": k2, "psnr_out": p_out}
    return result


# the learned-prox ADMM of scripts/train.py --arch learned_prox at its
# factory's width (default_learned_prox: 10 shared stages, hidden 32, depth
# 3, remat), trained as phase 11 trains the flagship; the deblurring part
# takes scripts/eval_algs.py's deblur protocol PSF, a 9x9 Gaussian of sigma 1.5
LP_LR, LP_KERN, LP_SIGMA = 8.8e-4, 9, 1.5


def learned_prox_training(dev, rng):
    """Phase 15: the learned-prox ADMM at its full width through
    ``scripts.train``'s ``build_model`` and ``run_training``, on phase 11's
    synthetic images (numpy seed 11) and loader settings (batch 3, 256^2
    crops, AWGN sigma in [0, 15)/255, SSIMLabColorLoss, AdamW at 8.8e-4):
    (a) denoising (``--lp_kern 0``): the fresh model against K2's aniso
    solve of the same 10 iterations, 2 epochs, then 4 steps on a fixed
    batch at 1/100 of the LR; (b) non-blind deblurring (``--lp_kern 9
    --lp_psf_sigma 1.5 --blur_gaussian 1.5``): no ``w``, the fresh model
    against K2 with the PSF, 1 epoch and the 4 fixed-batch steps. Returns
    the numbers and (a)'s best checkpoint."""
    from torch_admm_deconv_tpu_torch.data import (
        AddAWGN,
        CircBlur,
        DataLoader,
        RandCrop,
        Scale,
        gaussian_psf_np,
    )
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv
    from torch_admm_deconv_tpu_torch.scripts.train import build_model, run_training
    from torch_admm_deconv_tpu_torch.train import NNSaver

    images = [synthetic_image(rng, 3, 320, 320) * 255.0 for _ in range(14)]
    psf = gaussian_psf_np(LP_KERN, LP_SIGMA)
    kern = torch.from_numpy(psf.reshape(1, 1, LP_KERN, LP_KERN)).to(dev)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_lp_")
    result = {"checkpoint_dir": out_dir}
    for part, lp_kern, lp_sigma, epochs in (("denoise", 0, 0.0, 2),
                                            ("deblur", LP_KERN, LP_SIGMA, 1)):
        blur = [CircBlur(psf)] if lp_kern else []
        transforms = [RandCrop((256, 256)), Scale(), *blur, AddAWGN(std_range=(0, 15))]
        train_loader = DataLoader(SyntheticPairs(images[:6], transforms), TRAIN_BATCH, seed=0)
        eval_loader = DataLoader(SyntheticPairs(images[6:], transforms), EVAL_BATCH, seed=1)
        fixed = [next(iter(train_loader))]
        model = build_model("learned_prox", lp_kern=lp_kern, lp_psf_sigma=lp_sigma, device=dev,
                            generator=torch.Generator().manual_seed(0))
        require("w" not in dict(model.named_parameters()),
                f"learned prox {part}: a fixed PSF (or none) must leave no w")

        # at init the output conv is zero: the classical aniso solve, on K2
        tile = torch.from_numpy(fixed[0][0][:1]).to(dev)
        with torch.inference_mode():
            fresh = model(tile)
            k2 = admm_tv(tile, 0.05, 1.0, kern if lp_kern else None, iso=False, maxit=10,
                         use_pallas=True, device=dev)
            times = []
            for _ in range(5):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                model(tile)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
        init_err = max_diff(fresh, k2)
        log(f"learned prox {part} at init (1, 3, 256, 256): max|model - K2 aniso x10| "
            f"{init_err:.3e} (tol 1e-5); forward median {statistics.median(times):.3f} ms over 5 "
            f"{[round(t, 3) for t in times]} (CUDA events)")
        require(init_err <= 1e-5, f"learned prox {part}: fresh model is not the aniso solve: "
                                  f"{init_err}")

        step_s, step_peak = [], []
        undo = _timed_train_steps(step_s, step_peak)
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = run_training(model, train_loader, eval_loader, LP_LR, epochs,
                                       NNSaver(out_dir, f"lp_{part}"))
                fixed_losses = []  # the loss before each of the 4 steps, then after the last
                for _ in range(4):
                    trainer.train(fixed, lambda step: FIXED_LR)
                    fixed_losses.append(trainer.logger.get_avg_metrics("train")["color_lab_loss"])
                trainer.eval(fixed)
                fixed_losses.append(trainer.logger.get_avg_metrics("eval")["color_lab_loss"])
        finally:
            undo()
        logged = {k: list(v) for k, v in trainer.logger.get_logged().items() if v}
        lam_rho = {n: float(p.detach()) for n, p in model.named_parameters()
                   if n in ("lmbda", "rho")}
        warm = step_s[1:]
        log(f"learned prox {part} training (batch {TRAIN_BATCH}, 256^2): {len(step_s) - 4} steps "
            f"in {epochs} epochs and 4 on a fixed batch, warm steps (median of {len(warm)}, min-max) "
            f"{statistics.median(warm):.4f} s [{min(warm):.4f}, {max(warm):.4f}] (first "
            f"{step_s[0]:.4f} s), peak memory of a step {max(step_peak) / 2**30:.3f} GiB; epoch "
            f"losses train {logged['train_color_lab_loss']} eval {logged['eval_color_lab_loss']}, "
            f"eval PSNR {logged['eval_psnr']}; fixed batch loss at lr {FIXED_LR} "
            f"{[round(v, 6) for v in fixed_losses]}; skipped updates {trainer.skipped_updates}; "
            f"lambda/rho {lam_rho}")
        require(trainer.skipped_updates == 0, f"learned prox {part}: skipped an update")
        require(all(math.isfinite(v) for vals in logged.values() for v in vals)
                and all(math.isfinite(v) for v in fixed_losses),
                f"learned prox {part}: non-finite")
        require(fixed_losses[-1] < fixed_losses[0],
                f"learned prox {part}: the fixed-batch loss did not fall")
        require(all(1e-12 <= v <= 5.0 for v in lam_rho.values()),
                f"learned prox {part}: lambda or rho left [1e-12, 5]")
        result[part] = {"init_err_vs_k2": init_err, "forward_ms": times, "step_s": step_s,
                        "step_s_median": statistics.median(warm),
                        "peak_memory_bytes": max(step_peak), "fixed_batch_loss": fixed_losses,
                        "logged": logged, "lambda_rho": lam_rho}
    best = sorted(Path(out_dir).glob("lp_denoise/*/*.tar"))
    require(len(best) > 0, "learned prox: no checkpoint saved")
    result["best_checkpoint"] = str(best[-1])
    return result


def _zoo_models(use_pallas: bool, device):
    """The zoo at the constructions of tests/test_models.py:100-176 and
    tests/test_misc.py:9 for a (1, 3, 256, 256) input, weights from seed 0,
    every ADMM layer at ADMMDeconv's default 100 iterations; with
    ``use_pallas`` they run on K2 at batch 1 ('compat' as 'sample')."""
    from torch_admm_deconv_tpu_torch import models as zoo

    admm = {"kern_size": (), "use_pallas": use_pallas}

    def gelu(v):
        return torch.nn.functional.gelu(v, approximate="tanh")

    builders = {
        "Restorer": lambda **kw: zoo.Restorer(
            3, dict(in_channels=6, enc_out_channels=[8, 8], dec_out_channels=[8, 4],
                    kernel_sizes=[3, 3]),
            dict(in_channels=6, out_channels=[8, 8], kernel_sizes=[3, 3]), [dict(admm)] * 2, **kw),
        "ADMMFusion": lambda **kw: zoo.ADMMFusion([dict(admm)] * 2, 3, **kw),
        "ADMMFusion(with_admms)": lambda **kw: zoo.ADMMFusion([dict(admm)] * 2, 3,
                                                              with_admms=True, **kw),
        "RestorerV2(MultiADMM)": lambda **kw: zoo.RestorerV2(
            3, [8, 8], [8, 8], [2, 2], admms=[dict(admm, iso=True)], **kw),
        "Autoencoder": lambda **kw: zoo.Autoencoder(3, [8, 16], [8, 3], [3, 3],
                                                    activation=gelu, **kw),
        "ParallelUpsampleReduce": lambda **kw: zoo.ParallelUpsampleReduce(3, 2, 3, [3, 5, 7],
                                                                          **kw),
        # one processor per patch: 64^2 patches at stride 64 tile 256^2 16 times
        "LocalAttentionPatch": lambda **kw: zoo.LocalAttentionPatch(64, 64, 16, 3, **kw),
        "ChannelwiseVariance": lambda **kw: zoo.ChannelwiseVariance(),
    }
    return {name: build(device=device, generator=torch.Generator().manual_seed(0)).eval()
            for name, build in builders.items()}


def zoo_on_the_card(dev, rng, ckpt):
    """Phase 16: the learned-prox column of the eval harness
    (``eval_algs.evaluate_pair`` with ``learned_prox_column``, as
    ``--model learned_prox`` builds it) from phase 15's best denoising
    checkpoint on phase 12's 4 synthetic images; then each zoo model's
    forward at (1, 3, 256, 256) on the card (its ADMM layers on K2) against
    the same weights on the CPU, TF32 off, and its ADMM layers against a
    loop-path copy on the card. Returns the numbers and K2's expected
    launches."""
    from torch_admm_deconv_tpu_torch.data import AddAWGN, DataLoader, RandCrop, Scale
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver
    from torch_admm_deconv_tpu_torch.models import ADMMDeconv
    from torch_admm_deconv_tpu_torch.scripts import eval_algs

    images = [synthetic_image(rng, 3, 320, 320) * 255.0 for _ in range(EVAL_IMAGES)]
    transforms = [RandCrop(256), Scale(), AddAWGN(std_range=(15, 16))]
    loader = DataLoader(SyntheticPairs(images, transforms), 1, shuffle=False, seed=0,
                        drop_last=False)
    columns = {"model": eval_algs.learned_prox_column(ckpt, 0, 0.0, device=dev)}
    rows, seconds, noisy_psnr = [], [], []
    for i, (x, y) in enumerate(loader):
        outs, image_rows, secs = eval_algs.evaluate_pair(x, y, columns, device=dev)
        require(np.isfinite(outs["model"]).all() and outs["model"].shape == x.shape,
                "learned-prox column: output malformed")
        rows += [{"image": i, **r} for r in image_rows]
        seconds.append(secs["model"])
        noisy_psnr.append(psnr(x, y))
    column = {"s_per_image": statistics.mean(seconds), "seconds": seconds,
              "mean_psnr": float(np.mean([r["psnr"] for r in rows])),
              "noisy_psnr": float(np.mean(noisy_psnr)), "rows": rows}
    for line in eval_algs.summary(rows, column["s_per_image"]):
        log(f"learned-prox column (--model learned_prox): {line}")
    log(f"learned-prox column ({len(rows)} images of 3x256x256): {column['s_per_image']:.4f} "
        f"s/image {[round(t, 4) for t in seconds]}, mean PSNR {column['mean_psnr']:.3f} dB, "
        f"noisy {column['noisy_psnr']:.3f} dB")

    x = torch.from_numpy(synthetic_image(rng, 3, 256, 256)[None])
    x = x + 15.0 / 255.0 * torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    xt = x.to(dev)
    kernel_models, loop_models = _zoo_models(True, dev), _zoo_models(False, dev)
    cpu_models = _zoo_models(True, "cpu")
    expected_k2 = 0
    zoo = {}
    for name, model in kernel_models.items():
        admms = [m for m in model.modules() if isinstance(m, ADMMDeconv)]
        expected_k2 += len(admms)
        loop, cpu = loop_models[name], cpu_models[name]
        loop.load_state_dict(model.state_dict())
        cpu.load_state_dict(model.state_dict())
        layers = {}
        for tag, net in (("kernel", model), ("loop", loop)):
            for j, m in enumerate(mm for mm in net.modules() if isinstance(mm, ADMMDeconv)):
                m.register_forward_hook(
                    lambda mod, inp, out, key=(tag, j): layers.__setitem__(key, out))
        with torch.inference_mode():
            before = vmem_solver.LAUNCHES.n
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = model(xt)
            end.record()
            end.synchronize()
            launched = vmem_solver.LAUNCHES.n - before
            loop(xt)
            want = cpu(x)
        err = float((out.cpu() - want).abs().max())
        layer_err = max((max_diff(layers[("kernel", j)], layers[("loop", j)])
                         for j in range(len(admms))), default=0.0)
        zoo[name] = {"shape": list(out.shape), "err_vs_cpu": err, "admm_layers": len(admms),
                     "admm_err_vs_loop": layer_err, "k2_launches": launched,
                     "first_forward_ms": start.elapsed_time(end)}
        log(f"zoo {name} (1, 3, 256, 256) -> {tuple(out.shape)}: max|card - CPU| {err:.3e} "
            f"(tol 1e-4, TF32 off); {len(admms)} ADMM layers, K2 launches {launched}, "
            f"max|kernel - loop| {layer_err:.3e} (tol 1e-4); first forward "
            f"{zoo[name]['first_forward_ms']:.3f} ms (CUDA events)")
        require(torch.isfinite(out).all(), f"zoo {name}: non-finite output")
        require(launched == len(admms), f"zoo {name}: {launched} K2 launches for {len(admms)} "
                                        "ADMM layers")
        require(layer_err <= 1e-4, f"zoo {name}: ADMM layers disagree with the loop: {layer_err}")
        require(err <= 1e-4, f"zoo {name}: the card disagrees with the CPU: {err}")
    return {"learned_prox_column": column, "zoo": zoo, "expected_k2": expected_k2}


# -- the multi-device paths (phases 17-18): torch.distributed ranks ---------
# One rank per card (NCCL refuses two ranks on one GPU), each a fresh process
# of this script in worker mode, started by torch.distributed.run in a
# session of its own and killed with it when it outlasts RANKS_TIMEOUT_S; a
# collective fails after the process group's timeout (120 s in the workers,
# the megapixel script's default 600 s there).
RANKS_TIMEOUT_S = 300
# BASELINE config 5 as scripts/megapixel_bench.py sets it: 4096^2 RGB, a 9x9
# Gaussian of sigma 1.5, AWGN 0.005, lambda 0.002, rho 0.5, 50 iterations,
# halo 32; each mode held against the unsharded admm_tv at JAX's deblur bars
# (tests/test_spatial.py:87,219)
MP_SIZE = 4096
MP_BARS = {"pencil": 5e-4, "halo": 1e-3}
# the adaptive solve in the form of examples/megapixel_demo.py --adaptive: a
# one-channel 4096^2 checkerboard (128-pixel squares, AWGN 0.05), lambda 0.05,
# rho 1, tol 1e-4, pencil mode, at spatial_admm_tv_adaptive's maxit of 500
MP_ADAPTIVE = dict(lmbd=0.05, rho=1.0, tol=1e-4, maxit=500)
# BASELINE config 4 as scripts/train_dp.py sets it: default_learned_prox (10
# stages, hidden 32), the deblur protocol (9x9 Gaussian of sigma 1.5, circular
# blur, AWGN 5/255), global batch 8 of 256^2 crops, lr 8.8e-4,
# SSIMLabColorLoss; cut to phase 11's synthetic images (numpy seed 11, 16
# train and 8 eval, 3x320x320), 1 epoch, no corpus
DP = dict(steps=10, blur_gaussian=1.5, blur_ksize=9, awgn=5, global_batch=8, crop=256,
          lr=8.8e-4)


def kernel_launches() -> dict:
    """The K1-K4 launch counts of this process."""
    from torch_admm_deconv_tpu_torch.kernels import fused_admm, vmem_solver

    return {"fused_elementwise_step": fused_admm.LAUNCHES.n, "admm_tv_vmem": vmem_solver.LAUNCHES.n,
            "admm_tv_vmem_interleaved": vmem_solver.INTERLEAVED_LAUNCHES.n,
            "admm_tv_adaptive_vmem": vmem_solver.ADAPTIVE_LAUNCHES.n}


def reset_kernel_launches() -> None:
    from torch_admm_deconv_tpu_torch.kernels import fused_admm, vmem_solver

    for counter in (fused_admm.LAUNCHES, vmem_solver.LAUNCHES, vmem_solver.INTERLEAVED_LAUNCHES,
                    vmem_solver.ADAPTIVE_LAUNCHES):
        counter.reset()


def run_ranks(*worker_args: str) -> list:
    """``chip_smoke.py --worker ...`` on ``torch.cuda.device_count()`` ranks
    through ``torch.distributed.run``; fails unless every rank exits 0
    within ``RANKS_TIMEOUT_S``. Returns the JSON objects the ranks printed,
    and checks that each rank reported its kernel launches."""
    n = torch.cuda.device_count()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}", str(Path(__file__).resolve()), "--worker", *worker_args]
    proc = subprocess.Popen(cmd, cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RANKS_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise RuntimeError(f"ranks {worker_args} outlasted {RANKS_TIMEOUT_S} s:\n{err[-3000:]}")
    require(proc.returncode == 0,
            f"ranks {worker_args} failed (rc {proc.returncode}):\n{out[-2000:]}\n{err[-4000:]}")
    objs = json_objects(out)
    ranks = sorted(o["rank"] for o in objs if "launches" in o)
    require(ranks == list(range(n)), f"ranks {worker_args}: launch counts from ranks {ranks}")
    return objs


def emit(obj) -> None:
    """One JSON line in one write: the ranks share the launcher's stdout,
    unbuffered, where print() writes the text and the newline apart."""
    os.write(sys.stdout.fileno(), (json.dumps(obj) + "\n").encode())


def json_objects(text: str) -> list:
    """Every JSON object in ``text``, also where two ranks' lines ran
    together."""
    dec, objs, i = json.JSONDecoder(), [], text.find("{")
    while i != -1:
        try:
            obj, i = dec.raw_decode(text, i)
            objs.append(obj)
        except json.JSONDecodeError:
            i += 1
        i = text.find("{", i)
    return objs


def summed_launches(objs) -> dict:
    total = {}
    for o in objs:
        for name, c in o.get("launches", {}).items():
            total[name] = total.get(name, 0) + c
    return total


def megapixel_paths() -> dict:
    """Phase 17: BASELINE config 5 through ``scripts/megapixel_bench.py`` in
    both x-update modes, then the residual-stopped form, each on every card
    (one rank a card)."""
    result, launches = {}, []
    for mode in ("halo", "pencil"):
        t0 = time.perf_counter()
        objs = run_ranks("megapixel", "--size", str(MP_SIZE), "--x_update_mode", mode)
        wall = time.perf_counter() - t0
        lines = {o["metric"]: o for o in objs if "metric" in o}
        rate = next(v for k, v in lines.items() if k.startswith(f"megapixel_{MP_SIZE}x"))
        oracle = lines["megapixel_max_err_vs_unsharded_oracle"]
        device = lines["megapixel_device"]
        launches.append(summed_launches(objs))
        log(f"megapixel {MP_SIZE}^2 RGB {mode} on {device['ranks']} rank(s): "
            f"{rate['value']:.3f} iterations/s (best of 3 solves of 50, {rate['solve_s']:.4f} s), "
            f"PSNR {rate['psnr_blurred']:.3f} -> {rate['psnr_restored']:.3f} dB, max|sharded - "
            f"unsharded admm_tv| {oracle['value']:.3e} (tol {MP_BARS[mode]}; unsharded solve "
            f"{oracle['oracle_solve_s']:.4f} s, best of 3), peak memory rank 0 "
            f"{device['peak_memory_bytes_rank0'] / 2**30:.3f} GiB, card {device['card']}; "
            f"launcher wall {wall:.1f} s")
        require(oracle["value"] <= MP_BARS[mode],
                f"megapixel {mode}: {oracle['value']} from the unsharded solve")
        require(rate["psnr_restored"] > rate["psnr_blurred"], f"megapixel {mode}: no PSNR gain")
        result[mode] = {"rate": rate, "oracle": oracle, "device": device, "launcher_s": wall}
    t0 = time.perf_counter()
    objs = run_ranks("megapixel_adaptive")
    wall = time.perf_counter() - t0
    ad = next(o for o in objs if o.get("metric") == "megapixel_adaptive")
    launches.append(summed_launches(objs))
    log(f"megapixel adaptive {MP_SIZE}^2 checkerboard pencil on {ad['ranks']} rank(s): "
        f"{ad['iters']} iterations (unsharded admm_tv_adaptive {ad['ref_iters']}), r "
        f"{ad['r_norm']:.3e} s {ad['s_norm']:.3e} (tol {MP_ADAPTIVE['tol']}), rho {ad['rho']}, "
        f"max|sharded - unsharded| {ad['max_err_vs_unsharded']:.3e}, PSNR {ad['psnr_noisy']:.3f} -> "
        f"{ad['psnr_restored']:.3f} dB, solve (first, second call) {ad['solve_s']} s, unsharded "
        f"{ad['unsharded_s']} s, peak memory rank 0 {ad['peak_memory_bytes_rank0'] / 2**30:.3f} "
        f"GiB; launcher wall {wall:.1f} s")
    require(ad["r_norm"] <= MP_ADAPTIVE["tol"] and ad["s_norm"] <= MP_ADAPTIVE["tol"],
            "megapixel adaptive: a residual above tol")
    require(abs(ad["iters"] - ad["ref_iters"]) <= 1,
            f"megapixel adaptive: {ad['iters']} iterations, unsharded {ad['ref_iters']}")
    result["adaptive"] = dict(ad, launcher_s=wall)
    result["launches"] = launches
    return result


def dp_data():
    """Phase 18's loaders and fixed global batch, the same in every process:
    phase 11's synthetic images (numpy seed 11) through the deblur
    protocol's transforms."""
    from torch_admm_deconv_tpu_torch.data import DataLoader
    from torch_admm_deconv_tpu_torch.scripts.train_dp import make_transforms

    rng = np.random.default_rng(11)
    images = [synthetic_image(rng, 3, 320, 320) * 255.0 for _ in range(24)]
    transforms = make_transforms(DP["crop"], DP["blur_gaussian"], DP["blur_ksize"], DP["awgn"])
    train = SyntheticPairs(images[:16], transforms)
    train_loader = DataLoader(train, DP["global_batch"], seed=0)
    eval_loader = DataLoader(SyntheticPairs(images[16:], transforms), 1, shuffle=False, seed=0,
                             drop_last=False)
    fixed = next(iter(DataLoader(train, DP["global_batch"], seed=0)))
    return train_loader, eval_loader, fixed


def dp_model(dev):
    from torch_admm_deconv_tpu_torch.scripts.train_dp import build_model

    return build_model(DP["steps"], DP["blur_gaussian"], DP["blur_ksize"], device=dev,
                       generator=torch.Generator().manual_seed(0))


def dp_training(dev) -> dict:
    """Phase 18: BASELINE config 4 through ``scripts/train_dp.py``'s
    functions on every card (one rank a card), then the 4-step loss
    sequence of its DDP step on one fixed global batch held against the
    port's single-process trainer step in this process, from the same
    weights (TF32 off and deterministic cuDNN on both sides)."""
    from torch_admm_deconv_tpu_torch.metrics import SSIMLabColorLoss
    from torch_admm_deconv_tpu_torch.train import MetricsLogger, NNTrainer, make_optimizer

    t0 = time.perf_counter()
    objs = run_ranks("dp_train")
    wall = time.perf_counter() - t0
    got = next(o for o in objs if o.get("metric") == "dp_training")

    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        _, _, fixed = dp_data()
        loss = SSIMLabColorLoss()
        logger = MetricsLogger(loss, [])
        trainer = NNTrainer(loss, [], None, logger)
        with contextlib.redirect_stdout(io.StringIO()):
            trainer.run(dp_model(dev), make_optimizer(DP["lr"]), 0, base_lr=DP["lr"])
            single = []
            for _ in range(4):
                trainer.train([fixed], lambda step: DP["lr"])
                single.append(logger.get_avg_metrics("train")[loss.m_name])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    rel_err = max(abs(a - b) / abs(b) for a, b in zip(got["fixed_losses"], single))
    warm = got["step_s"][1:]
    log(f"data-parallel learned prox on {got['ranks']} rank(s) ({got['backend']}), global batch "
        f"{DP['global_batch']} at {DP['crop']}^2: {got['epoch_steps']} steps in 1 epoch, train loss "
        f"{got['train_loss']:.6f}, eval loss {got['eval_loss']:.6f}, eval PSNR "
        f"{got['eval_psnr']:.3f} dB; warm steps (median of {len(warm)}, min-max) "
        f"{statistics.median(warm):.4f} s [{min(warm):.4f}, {max(warm):.4f}] (first "
        f"{got['step_s'][0]:.4f} s); peak memory {got['peak_memory_bytes'] / 2**30:.3f} GiB (max "
        f"over ranks); lambda/rho {got['lambda_rho']}; fixed-batch losses DDP "
        f"{got['fixed_losses']} single-process {single}, max rel diff {rel_err:.3e} (tol 1e-6); "
        f"launcher wall {wall:.1f} s")
    losses = [got["train_loss"], got["eval_loss"], *got["fixed_losses"], *single]
    require(all(math.isfinite(v) for v in losses), "data-parallel training: non-finite loss")
    require(all(1e-12 <= v <= 5.0 for v in got["lambda_rho"].values()),
            "data-parallel training: lambda or rho left [1e-12, 5]")
    require(got["checkpoints"] > 0, "data-parallel training: rank 0 saved no checkpoint")
    require(rel_err <= 1e-6, f"data-parallel step disagrees with the single-process step: {rel_err}")
    return dict(got, single_process_fixed_losses=single, fixed_rel_err=rel_err, launcher_s=wall,
                launches=summed_launches(objs))


def worker(name: str, args) -> int:
    """One rank of phase 17, 18 or 23, started by ``run_ranks``: NCCL on this
    rank's card. Prints its results (rank 0) and its kernel launches as
    JSON lines."""
    import torch.distributed as dist

    from torch_admm_deconv_tpu_torch.parallel import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_kernel_launches()
    if name == "megapixel":
        from torch_admm_deconv_tpu_torch.scripts import megapixel_bench

        megapixel_bench.main([*args, "--device", "cuda"])  # its own group, and its end
        emit({"rank": int(os.environ["RANK"]), "launches": kernel_launches()})
        return 0
    if name == "megapixel_demo":
        from torch_admm_deconv_tpu_torch.examples import megapixel_demo

        demo = megapixel_demo.main([*args, "--device", "cuda"])  # its own group, and its end
        rank = int(os.environ["RANK"])
        if rank == 0:
            emit({"metric": "megapixel_demo", **demo})
        emit({"rank": rank, "launches": kernel_launches()})
        return 0
    rank, n = init_distributed(device="cuda", timeout_s=120)
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        {"megapixel_adaptive": _megapixel_adaptive_rank, "dp_train": _dp_train_rank}[name](
            rank, n, dev)
        emit({"rank": rank, "launches": kernel_launches()})
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


def _megapixel_adaptive_rank(rank: int, n: int, dev) -> None:
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv_adaptive
    from torch_admm_deconv_tpu_torch.parallel import (
        gather_rows,
        make_mesh,
        shard_rows,
        spatial_admm_tv_adaptive,
    )

    mesh = make_mesh((n,), ("space",))
    yy, xx = np.mgrid[0:MP_SIZE, 0:MP_SIZE]
    img = 0.3 + 0.4 * ((yy // 128 + xx // 128) % 2)
    noisy = np.clip(img + 0.05 * np.random.default_rng(0).normal(size=img.shape), 0, 1)
    full = torch.from_numpy(noisy.astype(np.float32)[None, None])
    x = shard_rows(full, mesh).to(dev)
    kw = dict(MP_ADAPTIVE)
    lmbd, rho = kw.pop("lmbd"), kw.pop("rho")
    torch.cuda.reset_peak_memory_stats(dev)

    def timed_twice(solve):
        """The result and host times of a first call (cuFFT plans, NCCL's
        first collective) and a second, each ending in a synchronize."""
        times = []
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        return res, times

    res, solve_s = timed_twice(lambda: spatial_admm_tv_adaptive(
        x, lmbd, rho, None, mesh=mesh, x_update_mode="pencil", **kw))
    out = gather_rows(res.x, mesh)
    if rank == 0:
        ref, unsharded_s = timed_twice(lambda: admm_tv_adaptive(full.to(dev), lmbd, rho, None,
                                                                device=dev, **kw))
        restored = out[0, 0].cpu().numpy()
        emit({"metric": "megapixel_adaptive", "ranks": n, "iters": int(res.iters),
              "ref_iters": int(ref.iters), "r_norm": float(res.r_norm),
              "s_norm": float(res.s_norm), "rho": float(res.rho),
              "max_err_vs_unsharded": max_diff(out, ref.x),
              "psnr_noisy": psnr(noisy, img), "psnr_restored": psnr(restored, img),
              "solve_s": solve_s, "unsharded_s": unsharded_s,
              "peak_memory_bytes_rank0": torch.cuda.max_memory_allocated(dev)})


def _dp_train_rank(rank: int, n: int, dev) -> None:
    import torch.distributed as dist

    from torch_admm_deconv_tpu_torch.metrics import SSIMLabColorLoss
    from torch_admm_deconv_tpu_torch.parallel import (
        make_dp_train_step,
        make_mesh,
        process_batch_bounds,
        shard_host_batch,
    )
    from torch_admm_deconv_tpu_torch.scripts.train_dp import run_training
    from torch_admm_deconv_tpu_torch.train import NNSaver, make_optimizer

    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    mesh = make_mesh((n,), ("data",))
    train_loader, eval_loader, fixed = dp_data()
    model = dp_model(dev)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dp_") if rank == 0 else None
    try:
        torch.cuda.reset_peak_memory_stats(dev)
        with contextlib.redirect_stdout(io.StringIO()):
            hist = run_training(model, train_loader, eval_loader, DP["lr"], 1,
                                NNSaver(out_dir, "lp_dp") if rank == 0 else None,
                                DP["global_batch"], mesh)
        checkpoints = len(list(Path(out_dir).glob("lp_dp/*/*.tar"))) if rank == 0 else 0
    finally:
        if out_dir is not None:
            shutil.rmtree(out_dir, ignore_errors=True)
    lam_rho = {k: float(p.detach()) for k, p in model.named_parameters() if k in ("lmbda", "rho")}
    # the fixed-batch DDP steps from the same fresh weights as the reference
    step = make_dp_train_step(dp_model(dev), make_optimizer(DP["lr"]), SSIMLabColorLoss(), mesh)
    rows = process_batch_bounds(DP["global_batch"])
    xs, ys = (shard_host_batch(a[rows], mesh) for a in fixed)
    fixed_losses, step_s = [], list(hist["step_s"])
    for _ in range(4):
        t0 = time.perf_counter()
        fixed_losses.append(step(xs, ys, DP["lr"]))  # ends in a host read of the loss
        step_s.append(time.perf_counter() - t0)
    peak = torch.tensor(float(torch.cuda.max_memory_allocated(dev)), device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    if rank == 0:
        emit({"metric": "dp_training", "ranks": n, "backend": dist.get_backend(),
              "epoch_steps": hist["steps"][0], "train_loss": hist["train_loss"][0],
              "eval_loss": hist["eval_loss"][0], "eval_psnr": float(hist["eval_psnr"][0]),
              "step_s": step_s, "peak_memory_bytes": float(peak),
              "lambda_rho": lam_rho, "fixed_losses": fixed_losses,
              "checkpoints": checkpoints})


# -- the classical scripts, the native loader and the examples (phases 19-23)
# BASELINE config 3 as scripts/grid_sweep.py sets it: the default 7x7 grid,
# 100 iterations, 256^2 crops of the eval set as one batch; denoising at AWGN
# 15 and deblurring (9x9 Gaussian of sigma 1.5) at AWGN 5. Cut: the eval
# set's count (28 images, RESULTS.md "Eval protocol") of synthetic 3x320x320
# images (numpy seed 12, as phase 12 makes them); the corpus is not in the repo
GRID_IMAGES = 28
GRID_AWGN = {"denoise": 15.0, "deblur": 5.0}
# the single-image anchor's protocol: the centre 256^2 crop, AWGN 15 from
# numpy seed 0, the admm column at the script's lambda 0.2 and rho 0.5
ANCHOR_AWGN, ANCHOR_LMBD, ANCHOR_RHO = 15.0, 0.2, 0.5
# the native loader: 16 synthetic 3x320^2 PNG pairs (x = y), one epoch at
# batch 3, 256^2 crops, AWGN sigma in [0, 15)/255, 4 worker threads
LOADER_IMAGES, LOADER_BATCH, LOADER_AWGN, LOADER_THREADS = 16, 3, (0, 15), 4
# examples/megapixel_demo.py at its defaults: a 2048^2 checkerboard, 50 iterations
DEMO_SIZE = 2048


def grid_sweep_phase(dev, rng) -> dict:
    """Phase 19: BASELINE config 3 through ``scripts.grid_sweep``'s
    ``degrade`` and ``sweep`` in both modes, the sweep timed as the script
    runs it. Then, outside the timer, every grid point again by a standalone
    ``admm_tv`` call: each row's PSNR (read back from the CSV the script
    writes) is held against 10 log10(1 / mean MSE) of that call's clipped
    output, and each row's metrics against that output's."""
    from torch_admm_deconv_tpu_torch.data import DataLoader, RandCrop, Scale
    from torch_admm_deconv_tpu_torch.metrics import functional as F
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv
    from torch_admm_deconv_tpu_torch.scripts import grid_sweep

    parser = grid_sweep.build_parser()
    lmbds = [float(v) for v in parser.get_default("lmbd_grid").split(",")]
    rhos = [float(v) for v in parser.get_default("rho_grid").split(",")]
    crop, maxit = parser.get_default("crop"), parser.get_default("maxit")
    images = [synthetic_image(rng, 3, 320, 320) * 255.0 for _ in range(GRID_IMAGES)]
    loader = DataLoader(SyntheticPairs(images, [RandCrop(crop), Scale()]), 1, shuffle=False,
                        seed=parser.get_default("seed"), drop_last=False)
    clean = np.concatenate([y for _, y in loader], axis=0)
    yt = torch.from_numpy(clean).to(dev)
    result = {}
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_grid_")
    try:
        for mode, awgn in GRID_AWGN.items():
            noisy, kern = grid_sweep.degrade(clean, mode, awgn, crop, parser.get_default("seed"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = grid_sweep.sweep(clean, noisy, kern, lmbds, rhos, maxit, dev)
            wall = time.perf_counter() - t0
            csv_path = Path(out_dir) / f"grid_{mode}_awgn{int(awgn)}.csv"
            grid_sweep.write_csv(rows, csv_path)
            with open(csv_path) as f:
                csv_rows = list(csv.DictReader(f))
            lines = grid_sweep.summary_lines(rows, clean, noisy, mode, awgn,
                                             (len(lmbds), len(rhos)), wall, csv_path)
            for line in lines:
                log(line)
            require(len(rows) == len(csv_rows) == len(lmbds) * len(rhos),
                    f"grid {mode}: rows missing")
            # every point again, alone: nothing may leak between points
            xt = torch.from_numpy(noisy).to(dev)
            kt = None if kern is None else torch.from_numpy(kern).to(dev)
            psnr_err = alone_err = 0.0
            for row, csv_row in zip(rows, csv_rows):
                with torch.inference_mode():
                    out = torch.clamp(admm_tv(xt, row["lmbd"], row["rho"], kt, iso=True,
                                              maxit=maxit, device=dev), 0.0, 1.0)
                    mse = float(((out.double() - yt.double()) ** 2).mean(dim=(1, 2, 3)).mean())
                    alone = {"ssim": float(F.ssim(out, yt)), "uiq": float(F.uiq(out, yt)),
                             "scc": float(F.scc(out, yt)), "psnr_from_mean_mse": 10.0 * math.log10(
                                 1.0 / float(torch.mean((out - yt) ** 2, dim=(1, 2, 3)).mean()))}
                psnr_err = max(psnr_err, abs(float(csv_row["psnr_from_mean_mse"])
                                             - 10.0 * math.log10(1.0 / mse)))
                alone_err = max(alone_err, max(abs(alone[k] - row[k]) for k in alone))
            best = max(rows, key=lambda r: r["psnr_from_mean_mse"])
            noisy_psnr = psnr(noisy, clean)
            log(f"grid sweep {mode} ({GRID_IMAGES} images of 3x{crop}^2, {len(rows)} points x "
                f"{maxit} iterations): wall {wall:.3f} s, {wall / len(rows) * 1e3:.2f} ms a point; "
                f"degraded {noisy_psnr:.3f} dB, best lmbd {best['lmbd']} rho {best['rho']} "
                f"{best['psnr_from_mean_mse']:.3f} dB (SSIM {best['ssim']:.4f}); max|CSV PSNR - "
                f"PSNR of the mean MSE of a standalone solve| {psnr_err:.3e} dB (tol 1e-4); "
                f"every point alone max|diff| {alone_err:.3e} (tol 1e-6)")
            require(all(math.isfinite(float(v)) for r in csv_rows for v in r.values()),
                    f"grid {mode}: a non-finite row")
            require(best["psnr_from_mean_mse"] > noisy_psnr, f"grid {mode}: no PSNR gain")
            require(psnr_err <= 1e-4, f"grid {mode}: CSV PSNR is not that of the mean MSE")
            require(alone_err <= 1e-6, f"grid {mode}: a point alone differs: {alone_err}")
            result[mode] = {"wall_s": wall, "ms_per_point": wall / len(rows) * 1e3,
                            "noisy_psnr": noisy_psnr, "best": best, "rows": rows,
                            "csv_psnr_err": psnr_err, "alone_err": alone_err}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return result


def anchor_phase(dev, rng, ckpt) -> dict:
    """Phase 20: ``scripts.single_image_anchor``'s ``anchor`` on the centre
    256^2 crop of one synthetic 320^2 image with phase 11's best checkpoint
    (K2 twice); its ADMM layers against a loop copy of the model."""
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer
    from torch_admm_deconv_tpu_torch.scripts import single_image_anchor as sia

    clean = sia.center_crop(synthetic_image(rng, 3, 320, 320).transpose(1, 2, 0))
    noisy = sia.add_noise(clean, ANCHOR_AWGN, 0)
    model = sia.load_model(ckpt, None, dev)
    loop_model = flagship_divergent_restorer(remat=False, use_pallas=False, device=dev)
    loop_model.load_state_dict(model.state_dict())
    loop_model.eval()
    layers = {}
    for tag, net in (("kernel", model), ("loop", loop_model)):
        for i in range(2):
            getattr(net.block_0, f"admm_{i}").register_forward_hook(
                lambda mod, inp, out, key=(tag, i): layers.__setitem__(key, out))
    before = kernel_launches()["admm_tv_vmem"]
    t0 = time.perf_counter()
    outs, rows = sia.anchor(clean, noisy, model, ANCHOR_LMBD, ANCHOR_RHO, dev)
    anchor_s = time.perf_counter() - t0
    k2 = kernel_launches()["admm_tv_vmem"] - before
    with torch.inference_mode():
        loop_model(torch.from_numpy(noisy).to(dev))
    layer_err = max(max_diff(layers[("kernel", i)], layers[("loop", i)]) for i in range(2))
    by = {r["method"]: r for r in rows}
    log(f"single-image anchor (1, 3, 256, 256), AWGN {ANCHOR_AWGN}: "
        + ", ".join(f"{r['method']} PSNR {r['psnr']:.3f} dB SSIM {r['ssim']:.4f}" for r in rows)
        + f"; {anchor_s:.3f} s; K2 launches {k2} (expected 2); model ADMM layers max|kernel - "
        f"loop| {layer_err:.3e} (tol 1e-4)")
    require(all(np.isfinite(outs[c]).all() and outs[c].shape == clean.shape
                for c in ("model", "admm")), "anchor: a column is malformed")
    require(by["admm"]["psnr"] > by["noisy"]["psnr"], "anchor: admm gains no PSNR")
    require(layer_err <= 1e-4, f"anchor: the model's ADMM layers disagree with the loop: "
                               f"{layer_err}")
    require(k2 == 2, f"anchor: K2 launched {k2} times, expected 2")
    return {"rows": rows, "seconds": anchor_s, "k2_launches": k2, "layer_err_vs_loop": layer_err}


def mixed_precision_phase(dev) -> dict:
    """Phase 21: ``scripts.bench_mixed_precision`` at its configuration, K2
    and K3 at (8, 3, 512, 512), through its functions; the study's own K2
    'high' and 'mixed' solves held against K2's plain version on its input,
    at phase 3's bars."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver
    from torch_admm_deconv_tpu_torch.scripts import bench_mixed_precision as bmp

    x = bmp.make_input(device=dev)
    study = bmp.study(x)
    for line in bmp.report_lines(study):
        log(f"mixed-precision study: {line}")
    outputs = study.pop("outputs")
    hty, freq, rho, tau, mats = vmem_solver.solve_inputs(x, bmp.LMBD, bmp.RHO, None)
    study["k2_vs_plain"] = {}
    for prec, tol in (("high", 2e-4), ("mixed", 2e-3)):
        fast = vmem_solver.fast_iterations(prec, 0.75, bmp.MAXIT)
        with torch.inference_mode():
            want = vmem_solver.admm_tv_vmem_plain(hty, freq, mats, rho, tau, None, bmp.MAXIT, fast)
        err = max_diff(outputs[prec], want)
        study["k2_vs_plain"][prec] = err
        log(f"mixed-precision study: K2 {prec} {tuple(x.shape)} aniso x{bmp.MAXIT} "
            f"(fast iterations {fast}) against its plain version: max|diff| {err:.3e} (tol {tol})")
        require(torch.isfinite(outputs[prec]).all() and err <= tol,
                f"mixed-precision study: K2 {prec} disagrees with its plain version: {err}")
    diff = study["mixed_vs_high"]
    # the bar chip_smoke holds 'mixed' kernels to against their plain versions
    require(math.isfinite(diff) and diff <= 2e-3,
            f"mixed-precision study: mixed against high {diff} at 200 iterations")
    for prec, a in study["adaptive"].items():
        for tol in bmp.TOLS:
            require(a["r_max"][tol] <= tol and a["s_max"][tol] <= tol,
                    f"mixed-precision study: K3 {prec} left a residual above {tol}")
        require(a["iters"][1e-5] > a["iters"][1e-3],
                f"mixed-precision study: K3 {prec} took no more iterations to 1e-5 than to 1e-3")
    return study


def write_png(path: Path, hwc: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``hwc`` (uint8), by zlib and struct."""
    h, w, _ = hwc.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + hwc[r].tobytes() for r in range(h))
    header = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))  # 8-bit RGB
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + header + chunk(b"IDAT", zlib.compress(raw))
                     + chunk(b"IEND", b""))


def native_loader_missing() -> list:
    """What the native loader's build needs and this machine lacks: the
    libpng and libjpeg headers and libraries."""
    missing = [h for h in ("/usr/include/png.h", "/usr/include/jpeglib.h") if not Path(h).exists()]
    libs = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True).stdout
    missing += [lib for lib in ("libpng", "libjpeg") if lib not in libs]
    return missing


def native_loader_phase(dev, rng) -> dict:
    """Phase 22: the native loader built with g++, one epoch of 16 PNG pairs
    (x = y) at batch 3, 256^2 crops, AWGN on x, 4 threads; each y an exact
    window of its source, x = y without noise; then one epoch of the
    learned prox's ``run_training`` fed by it."""
    from torch_admm_deconv_tpu_torch.runtime import native
    from torch_admm_deconv_tpu_torch.scripts.train import build_model, run_training
    from torch_admm_deconv_tpu_torch.train import NNSaver

    t0 = time.perf_counter()
    native.ensure_built()
    build_s = time.perf_counter() - t0
    data_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_loader_"))
    try:
        sources = [np.round(synthetic_image(rng, 3, 320, 320) * 255.0 + rng.integers(
            -20, 21, (3, 320, 320))).clip(0, 255).astype(np.uint8) for _ in range(LOADER_IMAGES)]
        for side in ("x", "y"):
            (data_dir / side).mkdir()
            for i, src in enumerate(sources):
                write_png(data_dir / side / f"{i:02d}.png", src.transpose(1, 2, 0))
        crop = (256, 256)

        def epoch(awgn):
            loader = native.NativeDataLoader.from_dirs(
                data_dir / "x", data_dir / "y", LOADER_BATCH, crop, awgn_std_range=awgn, seed=0,
                n_threads=LOADER_THREADS)
            try:
                t0 = time.perf_counter()
                batches = list(loader)
                return batches, len(batches) / (time.perf_counter() - t0)
            finally:
                loader.close()

        windows = np.stack([np.lib.stride_tricks.sliding_window_view(s[0], (4, 4))
                            for s in sources])
        for awgn in ((0, 0), LOADER_AWGN):
            batches, rate = epoch(awgn)
            require(len(batches) == LOADER_IMAGES // LOADER_BATCH, "loader: batches missing")
            spread = []
            for x, y in batches:
                require(x.shape == y.shape == (LOADER_BATCH, 3, *crop) and x.dtype == np.float32
                        and y.dtype == np.float32, "loader: batch malformed")
                require(0.0 <= x.min() and x.max() <= 1.0 and 0.0 <= y.min() and y.max() <= 1.0,
                        "loader: values outside [0, 1]")
                for yi in y:
                    # the one source window whose top-left 4x4 matches, then all of it
                    key = np.round(yi[0, :4, :4] * 255.0).astype(np.uint8)
                    hits = np.argwhere((windows == key).all(axis=(-2, -1)))
                    windows_y = (sources[i][:, t:t + crop[0], l:l + crop[1]].astype(np.float32)
                                 / np.float32(255.0) for i, t, l in hits)
                    require(any(np.array_equal(w, yi) for w in windows_y),
                            "loader: y is no window of a source image")
                if awgn == (0, 0):
                    require(np.array_equal(x, y), "loader: x differs from y without noise")
                spread += [float(np.std(xi - yi)) for xi, yi in zip(x, y)]
            top = (awgn[1] - 1) / 255.0 if awgn[1] else 0.0
            log(f"native loader awgn {awgn}: {len(batches)} batches of "
                f"{LOADER_BATCH}x3x{crop[0]}^2 "
                f"on {LOADER_THREADS} threads, {rate:.2f} batches/s; std(x - y) per sample "
                f"{min(spread):.4f}-{max(spread):.4f} (at most sigma {top:.4f})")
            require(max(spread) <= 1.05 * top + 1e-7, "loader: x - y spread beyond the AWGN range")
            if awgn != (0, 0):
                require(max(spread) > 0.0, "loader: no noise on x")
        # one epoch of the learned prox's training, fed by the native loader
        train = native.NativeDataLoader.from_dirs(data_dir / "x", data_dir / "y", LOADER_BATCH,
                                                  crop, awgn_std_range=LOADER_AWGN, seed=0,
                                                  n_threads=LOADER_THREADS)
        evals = native.NativeDataLoader.from_dirs(data_dir / "x", data_dir / "y", LOADER_BATCH,
                                                  crop, awgn_std_range=LOADER_AWGN, seed=1,
                                                  n_threads=LOADER_THREADS, shuffle=False)
        try:
            model = build_model("learned_prox", device=dev,
                                generator=torch.Generator().manual_seed(0))
            with contextlib.redirect_stdout(io.StringIO()):
                trainer = run_training(model, train, evals, LP_LR, 1,
                                       NNSaver(str(data_dir / "ckpt"), "lp_native"))
        finally:
            train.close()
            evals.close()
        logged = {k: list(v) for k, v in trainer.logger.get_logged().items() if v}
        log(f"learned prox fed by the native loader: 1 epoch, losses train "
            f"{logged['train_color_lab_loss']} eval {logged['eval_color_lab_loss']}")
        require(all(math.isfinite(v) for vals in logged.values() for v in vals),
                "loader-fed training: non-finite")
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    return {"build_s": build_s, "batches_per_s": rate, "logged": logged}


def examples_phase(dev) -> dict:
    """Phase 23: ``examples.solver_demo``'s ``run`` at its defaults, then
    ``examples/megapixel_demo.py`` at its defaults (2048^2, fixed) on every
    card, one rank a card."""
    from torch_admm_deconv_tpu_torch.examples import solver_demo

    clean = solver_demo.synthetic_image()
    t0 = time.perf_counter()
    demo = solver_demo.run(clean, device=dev)
    demo_s = time.perf_counter() - t0
    readings = {k: float(v) for k, v in demo.items() if not isinstance(v, np.ndarray)}
    log(f"solver demo (3, 256, 256): degraded {readings['psnr_degraded']:.3f} dB, restored "
        f"{readings['psnr_restored']:.3f} dB (300 iterations), adaptive "
        f"{readings['psnr_adaptive']:.3f} dB ({demo['adaptive_iters']} iterations, r "
        f"{readings['adaptive_r']:.3e} s {readings['adaptive_s']:.3e}, tol 1e-4); {demo_s:.3f} s")
    require(readings["psnr_restored"] > readings["psnr_degraded"]
            and readings["psnr_adaptive"] > readings["psnr_degraded"], "solver demo: no PSNR gain")
    require(readings["adaptive_r"] <= 1e-4, "solver demo: adaptive residual above 1e-4")
    t0 = time.perf_counter()
    objs = run_ranks("megapixel_demo", "--size", str(DEMO_SIZE))
    wall = time.perf_counter() - t0
    mp = next(o for o in objs if o.get("metric") == "megapixel_demo")
    log(f"megapixel demo {DEMO_SIZE}^2 fixed on {mp['ranks']} rank(s): {mp['iters']} iterations "
        f"in {mp['solve_s']:.3f} s (first call), PSNR {mp['psnr_noisy']:.3f} -> "
        f"{mp['psnr_restored']:.3f} dB; launcher wall {wall:.1f} s. Its --adaptive form runs at "
        f"{MP_SIZE}^2 in phase 17")
    require(mp["psnr_restored"] > mp["psnr_noisy"], "megapixel demo: no PSNR gain")
    return {"solver_demo": dict(readings, seconds=demo_s),
            "megapixel_demo": dict(mp, launcher_s=wall),
            "launches": summed_launches(objs)}


def classical_scripts_path(dev, ckpt) -> dict:
    """The seventh main path, phases 19-23: the grid sweep, the single-image
    anchor, the mixed-precision study, the native loader where it can build,
    and the examples. Prints each phase's K1-K4 launches and time; returns
    the phases' numbers and the path's launches (this process and the
    demo's ranks)."""
    out = {}

    def phase(number, key, fn, *args):
        before, t0 = kernel_launches(), time.perf_counter()
        out[key] = fn(*args)
        out[key]["phase_s"] = time.perf_counter() - t0
        out[key]["phase_launches"] = {name: c - before[name]
                                      for name, c in kernel_launches().items()}
        log(f"phase {number}: {out[key]['phase_s']:.1f} s, K1-K4 launches "
            f"{out[key]['phase_launches']}")
        return out[key]["phase_launches"]

    # phase 19: BASELINE config 3; the FFT loop, as in JAX
    require(not any(phase(19, "grid_sweep", grid_sweep_phase, dev,
                          np.random.default_rng(12)).values()),
            "grid sweep: a kernel launched")
    # phase 20: the single-image anchor, K2 twice (gated there)
    n = phase(20, "anchor", anchor_phase, dev, np.random.default_rng(20), ckpt)
    require(n["admm_tv_vmem"] == 2 and n["admm_tv_adaptive_vmem"] == 0
            and n["fused_elementwise_step"] == 0 and n["admm_tv_vmem_interleaved"] == 0,
            f"anchor: launches {n}")
    # phase 21: the mixed-precision study, K2 and K3
    n = phase(21, "mixed_precision", mixed_precision_phase, dev)
    require(n["admm_tv_vmem"] > 0 and n["admm_tv_adaptive_vmem"] > 0
            and n["fused_elementwise_step"] == 0 and n["admm_tv_vmem_interleaved"] == 0,
            f"mixed-precision study: launches {n}")
    # phase 22: the native loader, where libpng and libjpeg let it build
    missing = native_loader_missing()
    if missing:
        log(f"phase 22: not run: this machine lacks {missing}, which the native loader's build "
            f"(g++ -lpng -ljpeg) needs; the CPU tests hold the loader")
        out["native_loader"] = {"missing": missing}
    else:
        require(not any(phase(22, "native_loader", native_loader_phase, dev,
                              np.random.default_rng(22)).values()),
                "loader-fed training: a kernel launched")
    # phase 23: the examples; the loop in both, as in JAX
    require(not any(phase(23, "examples", examples_phase, dev).values()),
            "examples: a kernel launched")
    ranks = out["examples"].pop("launches")
    require(not any(ranks.values()), f"megapixel demo: launches on the ranks {ranks}")
    out["launches"] = summed_launches([{"launches": kernel_launches()}, {"launches": ranks}])
    log(f"seventh main path (phases 19-23): launches {out['launches']}")
    return out


def channel_pool_phase(dev) -> dict:
    """The spatial gates' channel pool (``csrc/channel_pool.cu``) against its
    plain version (the sort path), exactly, at the flagship's gate shape and
    at ragged shapes on both of the kernel's paths (registers to 128
    channels, shared memory above); its time at the flagship's gate beside
    its bound, the plain version's and ``torch.mode``'s (a yardstick the
    port never calls)."""
    from torch_admm_deconv_tpu_torch.kernels import channel_pool
    from torch_admm_deconv_tpu_torch.models.attention import channel_pool as pool
    from torch_admm_deconv_tpu_torch.models.attention import channel_pool_plain

    gen = torch.Generator().manual_seed(3)
    for shape in ((1, 86, 256, 256), (2, 1, 33, 47), (2, 86, 33, 47), (2, 129, 33, 47),
                  (2, 256, 33, 47)):
        for kind in ("random", "five levels"):
            x = (torch.randn(shape, generator=gen) if kind == "random"
                 else torch.randint(0, 5, shape, generator=gen).float()).to(dev)
            got, want = pool(x), channel_pool_plain(x)
            nan = got.isnan()  # the std of one channel
            require(torch.equal(nan, want.isnan()) and torch.equal(got[~nan], want[~nan]),
                    f"channel pool {kind} {shape} differs from the plain version")
    x = torch.randn((1, 86, 256, 256), generator=gen).to(dev)
    nbytes = (x.numel() + 2 * x[:, 0].numel()) * 4
    entry = {"name": "channel_pool", "route": "cuda",
             "source": "torch_admm_deconv_tpu_torch/csrc/channel_pool.cu", "replaces": None,
             "max_abs_err": 0.0, "ms": graph_ms(lambda: channel_pool.median_mode(x), 100),
             "pool_ms": graph_ms(lambda: pool(x), 100),
             "plain_ms": graph_ms(lambda: channel_pool_plain(x), 20),
             "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
             "library_ms": graph_ms(lambda: torch.mode(x, dim=1), 20)}
    log(f"channel pool (1, 86, 256, 256): kernel {entry['ms'] * 1e3:.2f} us (CUDA graph), with std and "
        f"stack {entry['pool_ms'] * 1e3:.2f} us, plain {entry['plain_ms'] * 1e3:.2f} us, bound "
        f"{entry['bound_ms'] * 1e3:.2f} us (bytes); torch.mode {entry['library_ms'] * 1e3:.2f} us; "
        f"equal to the plain version at 5 shapes x 2 kinds")
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2], sys.argv[3:])

    from torch_admm_deconv_tpu_torch.kernels import channel_pool, fused_admm, vmem_solver
    from torch_admm_deconv_tpu_torch.kernels._build import LIBRARIES, ptxas_kernels
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
    built = LIBRARIES.build()
    LIBRARIES.load("fused_admm")
    LIBRARIES.load("vmem_solver")
    LIBRARIES.load("vmem_adaptive")
    LIBRARIES.load("vmem_interleaved")
    LIBRARIES.load("channel_pool")
    log(f"build: {time.perf_counter() - t0:.3f} s (nvcc {LIBRARIES.build_seconds} s)")
    if LIBRARIES.ptxas_log:
        kernels = ptxas_kernels(LIBRARIES.ptxas_log)
        for k in kernels:
            log(f"ptxas: {k['kernel']}: {k['registers']} registers, {k['spill_stores']} bytes spill "
                f"stores, {k['spill_loads']} bytes spill loads")
        spills = sum(k["spill_stores"] for k in kernels)
        log(f"ptxas: {len(kernels)} kernels, max {max(k['registers'] for k in kernels)} "
            f"registers/thread, {spills} bytes spilled")
    # K2, K3 and K4 compute their products on the tensor cores
    for lib, kernel in (("vmem_solver", "k2_persistent"), ("vmem_adaptive", "k3_persistent"),
                        ("vmem_interleaved", "k4_persistent")):
        counts = {n: c for n, c in tensor_core_instructions(built / f"lib{lib}.so").items()
                  if kernel in n}
        for n, c in counts.items():
            log(f"SASS: {n}: {c} tensor-core instructions (HMMA/HGMMA)")
        require(len(counts) > 0 and min(counts.values()) > 0,
                f"{kernel}: no tensor-core instructions in its SASS")

    # -- phase 2: K1 against its plain version -------------------------------
    # same float32 chain, different association and FMA contraction: 1e-5
    k1_tol = 1e-5
    k1_flagship = None
    # the flagship tile, a ragged 250 x 190 batch, a plane smaller than one
    # tile and an odd W; rho and tau as numbers, as tensors on the card (tau
    # < 0 runs as 0) and as CPU tensors, one of them float64, which the
    # wrapper copies to the card as float32 before the launch
    scalars = ((0.7, 0.15), (torch.tensor(0.7, device=dev), torch.tensor(-0.1, device=dev)),
               (torch.tensor(0.7, dtype=torch.float64), torch.tensor(0.15)))
    for shape in ((1, 3, 256, 256), (2, 3, 250, 190), (1, 3, 5, 7), (2, 3, 9, 13)):
        for iso, mode in ((False, "joint"), (True, "sample"), (True, "joint")):
            x, ux, uy, hty = (torch.randn(shape, device=dev) for _ in range(4))
            err = 0.0
            for rho, tau in scalars:
                got = fused_admm.fused_elementwise_step(x, ux, uy, hty, rho, tau, iso, mode)
                rho_c = torch.as_tensor(rho, dtype=torch.float32, device=dev)
                tau_c = torch.clamp_min(torch.as_tensor(tau, dtype=torch.float32, device=dev), 0.0)
                want = _elementwise_step(x, ux, uy, hty, rho_c, tau_c, iso, mode)
                err = max(err, *(max_diff(got[i], want[i]) for i in (0, 3, 4)))
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
          "max_abs_err": err, "ms": k1_ms, "eager_ms": k1_call_ms, "plain_ms": k1_plain_ms,
          "bound_ms": max(k1_bytes / PEAK_BYTES, k1_ops / PEAK_F32_FLOPS) * 1e3,
          "bound_by": "bytes" if k1_bytes / PEAK_BYTES >= k1_ops / PEAK_F32_FLOPS else "operations",
          "library_ms": None}
    log(f"K1 (1, 3, 256, 256) sample: {k1_ms:.4f} ms (CUDA graph), plain {k1_plain_ms:.4f} ms, "
        f"bound {k1['bound_ms']:.4f} ms; eager call incl. Python {k1_call_ms:.4f} ms (CUDA events)")

    # -- phase 3: K2 against its plain version -------------------------------
    tile = synthetic_image(rng, 3, 256, 256)
    noisy_tile = tile + rng.normal(0.0, 15.0 / 255.0, tile.shape).astype(np.float32)
    gauss, motion = gaussian_psf(9, 1.5), motion_psf(9)
    batch8 = np.stack([synthetic_image(rng, 3, 256, 256) for _ in range(8)])
    batch8 += rng.normal(0.0, 15.0 / 255.0, batch8.shape).astype(np.float32)
    # 3xTF32 tensor-core products against cuBLAS f32 over 100 nonlinear
    # iterations: 2e-4; 'mixed' rounds operands to bf16, where a one-ulp flip
    # (~4e-3 relative) between the two summation orders survives a
    # 25-iteration tail: 2e-3
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
        bound_ms, bound_by, simt_ms = fixed_bound(hty_.numel(), *xt.shape[-2:], len(mats), 100, fast)
        share = require_share(f"K2 {name}", ms, bound_ms)
        extra_ms[name] = {"ms": ms, "bound_ms": bound_ms, "bound_f32_simt_ms": simt_ms}
        log(f"K2 {name}: {ms:.3f} ms (CUDA graph), bound {bound_ms:.4f} ms ({bound_by}; "
            f"{share:.1%} of it), f32 SIMT bound {simt_ms:.4f} ms")
        if name == "sample":
            k2_flagship = (err, ms, graph_ms(plain, 1, 3), bound_ms, bound_by, simt_ms)
            k2_calls = {depth: (lambda depth=depth: vmem_solver._WholeSolve.apply(
                hty_, freq, rho_t, tau_t, mode, depth, 0, None, *mats)) for depth in (10, 100)}
    err, k2_ms, k2_plain_ms, bound_ms, bound_by, simt_ms = k2_flagship

    # launches per solve: K2 at the flagship shape, K3 at the phase-7 shape
    xt3 = torch.from_numpy(noisy_tile[None]).to(dev)

    def k3_call(depth):
        cfg = vmem_solver.adaptive_config(xt3.shape, True, "sample", depth, 0.0, 10.0, 2.0,
                                          "high", None, False)
        inputs = vmem_solver.adaptive_inputs(xt3, 0.05, 0.8, None, cfg.g)
        return lambda: vmem_solver._AdaptiveSolve.apply(*inputs[:4], cfg, *inputs[4])

    per_solve_calls = {
        "K2 (1, 3, 256, 256) sample": k2_calls,
        "K3 (1, 3, 256, 256) sample tol 0": {depth: k3_call(depth) for depth in (20, 60)},
    }
    k2 = {"name": "admm_tv_vmem", "route": "cuda",
          "source": "torch_admm_deconv_tpu_torch/csrc/vmem_solver.cu",
          "replaces": "torch_admm_deconv_tpu/kernels/vmem_solver.py:213",
          "max_abs_err": err, "ms": k2_ms, "plain_ms": k2_plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by, "bound_f32_simt_ms": simt_ms,
          "library_ms": None}
    log(f"K2 flagship (1, 3, 256, 256) sample x100: {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms, f32 SIMT bound {simt_ms:.4f} ms")

    # -- phase 3b: the spatial gates' channel pool against its plain version --
    pool = channel_pool_phase(dev)

    # -- the main path: counts set to 0 just before, read just after ----------
    fused_admm.LAUNCHES.reset()
    vmem_solver.LAUNCHES.reset()
    channel_pool.LAUNCHES.reset()

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
        require(channel_pool.LAUNCHES.n == 42, "flagship forward must launch the channel pool 42 times")
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before, pools = vmem_solver.LAUNCHES.n, channel_pool.LAUNCHES.n
            start.record()
            model(xt)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            require(vmem_solver.LAUNCHES.n - before == 2, "flagship forward must launch K2 twice")
            require(channel_pool.LAUNCHES.n - pools == 42,
                    "flagship forward must launch the channel pool 42 times")
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
        f"(CUDA events), K2 launches/forward 2, channel pool 42; ADMM layers max|kernel - loop| {admm_err:.3e} (tol 1e-4); "
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

    launches = {"fused_elementwise_step": fused_admm.LAUNCHES.n, "admm_tv_vmem": vmem_solver.LAUNCHES.n,
                "channel_pool": channel_pool.LAUNCHES.n}
    for entry in (k1, k2, pool):
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
    per_solve_calls["K4 (8, 3, 256, 256) aniso"] = k4_cases.pop("k4_calls")

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

    # -- the third main path: counts set to 0 just before, read just after ---
    counters = {"fused_elementwise_step": fused_admm.LAUNCHES, "admm_tv_vmem": vmem_solver.LAUNCHES,
                "admm_tv_vmem_interleaved": vmem_solver.INTERLEAVED_LAUNCHES,
                "admm_tv_adaptive_vmem": vmem_solver.ADAPTIVE_LAUNCHES,
                "channel_pool": channel_pool.LAUNCHES}
    for counter in counters.values():
        counter.reset()
    # phase 11: flagship training, and its best checkpoint served through K2
    t_phase = time.perf_counter()
    flagship_train = flagship_training(dev, np.random.default_rng(11))
    flagship_train["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 11: {flagship_train['phase_s']:.1f} s")
    flagship_train["launches"] = {name: c.n for name, c in counters.items()}
    k2["launches_training_path"] = counters["admm_tv_vmem"].n
    require(k2["launches_training_path"] == 2,
            f"{k2['name']} was not launched twice on the training path")
    # the training steps' gates go through the pool's autograd path
    pool["launches_training_path"] = counters["channel_pool"].n
    require(pool["launches_training_path"] > 0, "the channel pool was not launched on the training path")

    # -- the fourth main path: counts set to 0 just before, read just after --
    for counter in counters.values():
        counter.reset()
    # phase 11's checkpoint serves phases 12 and 20; removed at exit
    TEMP_DIRS.append(flagship_train.pop("checkpoint_dir"))
    t_phase = time.perf_counter()
    # phase 12: the eval harness, its model column from phase 11's checkpoint
    harness = eval_harness(dev, np.random.default_rng(12), flagship_train["best_checkpoint"])
    harness["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 12: {harness['phase_s']:.1f} s")
    t_phase = time.perf_counter()
    # phase 13: NAFNet, the harness's comparison model, and its training
    naf = nafnet(dev, np.random.default_rng(13))
    naf["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 13: {naf['phase_s']:.1f} s")
    # phase 14: the serving script
    serving = serving_script(dev, np.random.default_rng(14))
    eval_launches = {name: c.n for name, c in counters.items()}
    # K2: the model column twice an image, the admm column once an image in
    # each protocol, the serving script once a batch of 8 tiles under --aniso
    expected = 4 * EVAL_IMAGES + serving["aniso"]["k2_launches"]
    k2["launches_eval_path"] = eval_launches["admm_tv_vmem"]
    log(f"fourth main path (phases 12-14): launches {eval_launches}")
    require(k2["launches_eval_path"] == expected,
            f"{k2['name']}: {k2['launches_eval_path']} launches on the eval path, expected {expected}")
    # -- the fifth main path: counts set to 0 just before, read just after ---
    for counter in counters.values():
        counter.reset()
    t_phase = time.perf_counter()
    # phase 15: the learned-prox ADMM trained at its full width
    learned = learned_prox_training(dev, np.random.default_rng(11))
    learned["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {learned['phase_s']:.1f} s")
    t_phase = time.perf_counter()
    try:
        # phase 16: its eval-harness column, and the rest of the zoo on the card
        zoo = zoo_on_the_card(dev, np.random.default_rng(16), learned["best_checkpoint"])
    finally:
        shutil.rmtree(learned.pop("checkpoint_dir"), ignore_errors=True)
    zoo["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 16: {zoo['phase_s']:.1f} s")
    zoo_launches = {name: c.n for name, c in counters.items()}
    # K2: the two init gates of phase 15 (aniso, without and with the PSF),
    # then one launch per ADMM layer of the zoo's forwards on the card
    expected = 2 + zoo.pop("expected_k2")
    k2["launches_zoo_path"] = zoo_launches["admm_tv_vmem"]
    log(f"fifth main path (phases 15-16): launches {zoo_launches}")
    require(k2["launches_zoo_path"] == expected,
            f"{k2['name']}: {k2['launches_zoo_path']} launches on the zoo path, expected {expected}")
    # -- the sixth main path: the multi-device paths, in torch.distributed
    # ranks, each a fresh process whose counts start at 0 and are read at its end
    torch.cuda.empty_cache()  # the ranks share this card
    t_phase = time.perf_counter()
    # phase 17: BASELINE config 5, the row-split megapixel solve
    megapixel = megapixel_paths()
    megapixel["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 17: {megapixel['phase_s']:.1f} s")
    t_phase = time.perf_counter()
    # phase 18: BASELINE config 4, data-parallel learned-prox training
    dp = dp_training(dev)
    dp["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {dp['phase_s']:.1f} s")
    # neither JAX path reaches a Pallas kernel: a launch here would be a
    # routing difference from the reference
    multi_launches = summed_launches([{"launches": c}
                                      for c in megapixel.pop("launches") + [dp.pop("launches")]])
    log(f"sixth main path (phases 17-18): launches summed over the ranks {multi_launches}")
    require(not any(multi_launches.values()), "a kernel launched on the multi-device paths")
    # -- the seventh main path: counts set to 0 just before, read just after --
    reset_kernel_launches()
    scripts = classical_scripts_path(dev, flagship_train["best_checkpoint"])
    script_launches = scripts.pop("launches")
    # device operations per K2, K3 and K4 solve, last: the timed phases run
    # before any profiler session
    (k2["device_ops_per_solve"], k3["device_ops_per_solve"],
     k4["device_ops_per_solve"]) = launches_per_solve(per_solve_calls).values()
    log(json.dumps({"k3_cases": k3_cases, "k4_cases": k4_cases, "classical": classical,
                    "training": training}))
    log(json.dumps({"flagship_training": flagship_train}))
    log(json.dumps({"eval_harness": harness, "nafnet": naf, "serving_script": serving}))
    log(json.dumps({"learned_prox": learned, "zoo": zoo}))
    log(json.dumps({"megapixel": megapixel, "dp_training": dp}))
    log(json.dumps({"classical_scripts": scripts}))
    for entry in (k1, k2, k3, k4):
        entry["launches_multidevice_path"] = multi_launches[entry["name"]]
        entry["launches_classical_scripts_path"] = script_launches[entry["name"]]
    log(json.dumps({"kernels": [k1, k2, k3, k4, pool]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for d in TEMP_DIRS:
            shutil.rmtree(d, ignore_errors=True)
    sys.exit(rc)
