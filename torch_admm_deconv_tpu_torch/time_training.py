"""Host-clock times of the implicit-gradient training steps, before and
after a ``torch.profiler`` session.

    python -m torch_admm_deconv_tpu_torch.time_training [--reps 5] [--prelude profiler]

Builds, from ``torch.Generator`` seed 0, the 'sample'
``ADMMDeconv(gradient_mode="implicit")`` layer (lambda 0.05, rho 1, at most
500 iterations; its forward is K3 on the card) and the full-width flagship
in implicit mode and in inference mode (``use_pallas=True``), and takes one
(1, 3, 256, 256) piecewise-constant tile with AWGN sigma 15/255 from numpy
seed 0. It then times two rounds of ``reps`` samples, each after one warm-up:
the layer's forward and its backward (50 Neumann terms), one
forward+backward step of the implicit flagship, and one inference forward
of the flagship, every sample on the host clock ending in a synchronize.
Between the rounds it runs a prelude, so the second round shows what the
prelude leaves behind in the process:

- ``profiler`` (default): one layer step under ``torch.profiler`` (CPU and
  CUDA activities);
- ``classical``: chip_smoke.py's phase-9 solves at (8, 3, 512, 512) on
  eight such images (aniso, lambda 0.05, rho0 0.8, tol 1e-5, maxit 2000):
  the FFT loop ``admm_tv_adaptive``, K3 in 'high' and 'mixed', and K3's
  plain version;
- ``float64``: K3's plain version of the same solve with float64 products,
  the reference that phase 9 holds K3's iteration counts against.

Prints one JSON line per round: every sample, and their median, min and
max. Fails without a GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch


def tile_pair(rng: np.random.Generator, c: int = 3, h: int = 256, w: int = 256):
    """(clean, noisy) (1, c, h, w) float32: boxes on a flat ground in
    [0.1, 0.9], the noisy one with AWGN sigma 15/255."""
    clean = np.empty((1, c, h, w), np.float32)
    for ch in range(c):
        plane = np.full((h, w), rng.uniform(0.2, 0.8), np.float32)
        for _ in range(12):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            hh, ww = rng.integers(h // 16, h // 4), rng.integers(w // 16, w // 4)
            plane[y0 : y0 + hh, x0 : x0 + ww] = rng.uniform(0.1, 0.9)
        clean[0, ch] = plane
    return clean, clean + rng.normal(0.0, 15.0 / 255.0, clean.shape).astype(np.float32)


def classical_prelude(dev: torch.device, float64: bool) -> None:
    """The phase-9 solves (``float64`` False) or the float64-product
    reference (True) at (8, 3, 512, 512)."""
    from torch_admm_deconv_tpu_torch.kernels import vmem_solver
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv_adaptive

    rng = np.random.default_rng(1)
    xt = torch.from_numpy(np.concatenate([tile_pair(rng, 3, 512, 512)[1] for _ in range(8)]))
    xt = xt.to(dev)
    cfg = vmem_solver.adaptive_config(xt.shape, False, "sample", 2000, 1e-5, 10.0, 2.0, "high",
                                      None, False)
    inputs = vmem_solver.adaptive_inputs(xt, 0.05, 0.8, None, 1)
    hty, habs2, d2, lr, mats = inputs
    if float64:
        xform = vmem_solver._xform
        vmem_solver._xform = lambda v, m, fast: xform(v.double(), [q.double() for q in m],
                                                      False).float()
        try:
            vmem_solver.admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lr, cfg)
        finally:
            vmem_solver._xform = xform
        return
    admm_tv_adaptive(xt, 0.05, 0.8, None, iso=False, maxit=2000, tol=1e-5, device=dev)
    for precision in ("high", "mixed"):
        vmem_solver.admm_tv_adaptive_vmem(xt, 0.05, 0.8, None, iso=False, maxit=2000, tol=1e-5,
                                          precision=precision, device=dev)
    vmem_solver.admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lr, cfg)


def main(argv=None) -> int:
    from torch_admm_deconv_tpu_torch._device import resolve_device
    from torch_admm_deconv_tpu_torch.models.admm_deconv import ADMMDeconv
    from torch_admm_deconv_tpu_torch.models.denoiser import flagship_divergent_restorer

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--prelude", choices=("profiler", "classical", "float64"),
                        default="profiler")
    args = parser.parse_args(argv)
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    clean_np, noisy_np = tile_pair(np.random.default_rng(0))
    clean, xin = torch.from_numpy(clean_np).to(dev), torch.from_numpy(noisy_np).to(dev)
    layer = ADMMDeconv(iso=True, iso_mode="sample", gradient_mode="implicit", max_iters=500,
                       device=dev, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        layer.lmbda.fill_(0.05)
        layer.rho.fill_(1.0)
    trained = flagship_divergent_restorer(gradient_mode="implicit", device=dev,
                                          generator=torch.Generator().manual_seed(0))
    served = flagship_divergent_restorer(remat=False, use_pallas=True, device=dev,
                                         generator=torch.Generator().manual_seed(0)).eval()

    def layer_step():
        layer.zero_grad()
        x = xin.clone().requires_grad_(True)
        t0 = time.perf_counter()
        y = layer(x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.mean((y - clean) ** 2).backward()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    def flagship_step():
        trained.zero_grad()
        t0 = time.perf_counter()
        torch.mean((trained(xin) - clean) ** 2).backward()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def flagship_forward():
        with torch.inference_mode():
            t0 = time.perf_counter()
            served(xin)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

    def round_(name: str) -> dict:
        layer_step(), flagship_step(), flagship_forward()  # warm-up
        steps = [layer_step() for _ in range(args.reps)]
        samples = {
            "layer_forward_s": [f for f, _ in steps],
            "layer_backward_s": [b for _, b in steps],
            "flagship_step_s": [flagship_step() for _ in range(args.reps)],
            "flagship_forward_s": [flagship_forward() for _ in range(args.reps)],
        }
        out = {"round": name, "device": torch.cuda.get_device_name(dev), "reps": args.reps}
        for key, xs in samples.items():
            out[key] = {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
                        "samples": xs}
        return out

    print(json.dumps(round_("fresh")), flush=True)
    if args.prelude == "profiler":
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function("layer step"):
                layer_step()
        prof.events()
    else:
        classical_prelude(dev, args.prelude == "float64")
        torch.cuda.synchronize()
    print(json.dumps(round_(f"after_{args.prelude}")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
