"""Device-time breakdown of the whole-solve kernels K3, K2 and K4 on the GPU.

    python -m torch_admm_deconv_tpu_torch.trace_solves

Traces five solves under ``torch.profiler``, each after one warm-up call
with the same inputs:

- K3 (``admm_tv_adaptive_vmem``) at (8, 3, 512, 512), aniso, lambda 0.05,
  rho0 0.8, tol 1e-5, maxit 2000, 'high' (the classical configuration);
- K3 at (1, 3, 256, 256), 'sample', lambda 0.05, rho 1 fixed, tol 1e-6,
  maxit 500, 'high' (the implicit layer's forward);
- K2 (``admm_tv_vmem``) at (1, 3, 256, 256), 'sample', lambda 0.05, rho 1,
  100 iterations (the flagship's ADMM layer);
- K2 and K4 (``admm_tv_vmem(schedule='interleaved')``) at (8, 3, 256, 256),
  aniso, lambda 0.05, rho 1, 100 iterations (the serving batch).

Inputs are synthetic piecewise-constant images plus Gaussian noise
(sigma 15/255) from numpy seed 0. For each solve it prints one JSON line:
the wall time by CUDA events, the summed device time of its kernels and the
busy share (summed kernel time over the wall time; one stream), and the
device time and launch count by kernel. K2, K3 and K4 are one persistent
launch each, which the profiler sees as one kernel, so a further call,
with the port's recorder on (``utils.tracing``), reads the kernel's own
stage clock: device time by stage, summed over the iterations, as the
grid's first CTA sees it between grid barriers (K4: between its cluster's
barriers). Fails without a GPU.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from torch_admm_deconv_tpu_torch.utils import tracing

def _device_us(event) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def noisy_images(rng: np.random.Generator, b: int, c: int, h: int, w: int) -> np.ndarray:
    """Piecewise-constant images in [0.1, 0.9] with AWGN sigma 15/255."""
    img = np.empty((b, c, h, w), np.float32)
    for i in range(b):
        for ch in range(c):
            plane = np.full((h, w), rng.uniform(0.2, 0.8), np.float32)
            for _ in range(12):
                y0, x0 = rng.integers(0, h), rng.integers(0, w)
                hh, ww = rng.integers(h // 16, h // 4), rng.integers(w // 16, w // 4)
                plane[y0 : y0 + hh, x0 : x0 + ww] = rng.uniform(0.1, 0.9)
            img[i, ch] = plane
    return img + rng.normal(0.0, 15.0 / 255.0, img.shape).astype(np.float32)


def adaptive_solve(x, lmbd, rho, iso, iso_mode, maxit, tol, rho_mu):
    """A K3 solve in 'high' as ``admm_tv_adaptive_vmem`` runs it: a function
    returning the blocks' iteration counts."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver

    cfg = vmem_solver.adaptive_config(x.shape, iso, iso_mode, maxit, tol, rho_mu, 2.0, "high",
                                      None, False)
    hty, habs2, d2, lr, mats = vmem_solver.adaptive_inputs(x, lmbd, rho, None, cfg.g)
    return lambda: vmem_solver._launch_adaptive(hty, habs2, d2, mats, lr, cfg)[5]


def fixed_solve(x, lmbd, rho, iso_mode, maxit, interleaved=False):
    """A K2 (or K4) solve in 'high' as ``admm_tv_vmem`` runs it, as a
    function."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver

    hty, freq, rho_t, tau_t, mats = vmem_solver.solve_inputs(x, lmbd, rho, None)
    rho_tau = torch.stack([rho_t, tau_t]).contiguous()
    if interleaved:
        pack = vmem_solver._fixed_pack(x.shape, iso_mode is not None, iso_mode or "joint")
        return lambda: vmem_solver._launch_interleaved(hty, freq, mats, rho_tau, iso_mode,
                                                       maxit, 0, pack)
    return lambda: vmem_solver._launch(hty, freq, mats, rho_tau, iso_mode, maxit, 0)


def trace(name: str, kind: str, fn) -> dict:
    """Profile one call of ``fn`` after a warm-up call, then read the stage
    clock of one more through the recorder."""
    result = fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        result = fn()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    by_kernel = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and _device_us(e) > 0:
            ms, n = by_kernel.get(e.key, (0.0, 0))
            by_kernel[e.key] = (ms + _device_us(e) / 1e3, n + e.count)
    busy = sum(ms for ms, _ in by_kernel.values())
    out = {
        "solve": name,
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms if wall_ms else None,
        "device_kernels": sum(n for _, n in by_kernel.values()),
        "kernels": {k[:100]: {"ms": ms, "launches": n} for k, (ms, n) in
                    sorted(by_kernel.items(), key=lambda kv: -kv[1][0])},
    }
    if kind == "K3":
        out["iterations_needed"] = int(result.max())
    with tracing.recording():
        fn()
    (clock,) = [c for c in tracing.drain()["counters"] if c["kernel"] == kind.lower()]
    out["stage_clock_ms"] = {stage: ns / 1e6 for stage, ns in clock["stage_ns"].items()}
    return out


def main() -> int:
    from torch_admm_deconv_tpu_torch._device import resolve_device

    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    big = torch.from_numpy(noisy_images(rng, 8, 3, 512, 512)).to(dev)
    tile = torch.from_numpy(noisy_images(rng, 1, 3, 256, 256)).to(dev)
    batch = torch.from_numpy(noisy_images(rng, 8, 3, 256, 256)).to(dev)
    solves = [
        ("K3 (8,3,512,512) aniso tol 1e-5 high", "K3",
         adaptive_solve(big, 0.05, 0.8, False, "sample", 2000, 1e-5, 10.0)),
        ("K3 (1,3,256,256) sample tol 1e-6 rho fixed high", "K3",
         adaptive_solve(tile, 0.05, 1.0, True, "sample", 500, 1e-6, 1e30)),
        ("K2 (1,3,256,256) sample x100 high", "K2", fixed_solve(tile, 0.05, 1.0, "sample", 100)),
        ("K2 (8,3,256,256) aniso x100 high", "K2", fixed_solve(batch, 0.05, 1.0, None, 100)),
        ("K4 (8,3,256,256) aniso x100 high", "K4", fixed_solve(batch, 0.05, 1.0, None, 100, True)),
    ]
    with torch.inference_mode():
        for name, kind, fn in solves:
            print(json.dumps(trace(name, kind, fn)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
