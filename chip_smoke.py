"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``torch_admm_deconv_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card, drives the main
path (the flagship DivergentRestorer forward at full width, classical tiled
TV-ADMM serving, and the solver loop with the fused step), checks its
outputs, and prints one JSON line of kernel numbers and, last, one JSON
status line. Exits non-zero, with no result line, when there is no GPU or a
phase fails.
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
        run = lambda: vmem_solver._WholeSolve.apply(hty_, freq, rho_t, tau_t, mode, 100, fast, *mats)  # noqa: E731
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
    log(json.dumps({"kernels": [k1, k2]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
