"""BASELINE config 5: a 4096x4096 RGB deblur with the image's rows split
over the ranks, halo exchange and distributed FFT between them.

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m torch_admm_deconv_tpu_torch.scripts.megapixel_bench [--device cpu]

Counterpart of the JAX package's ``scripts/megapixel_bench.py``, flag for
flag, plus ``--device`` (the GPU by default, one per rank, over NCCL; gloo
with ``--device cpu``; ``--platform`` is the JAX flag's name for it). Each
rank builds the same seeded piecewise-smooth scene, blurs it circularly with
a 9x9 Gaussian PSF (sigma 1.5), adds AWGN (sigma 0.005), and runs
``spatial_admm_tv`` over a ``space`` mesh of every rank on its rows. Rank 0
prints one JSON line with iterations/s, the best-of-3 solve time and the
PSNRs, then one with the error against the unsharded ``admm_tv`` on the same
input and that solve's time on rank 0's device (unless ``--skip_oracle``), then one with the card's name and power
limit and the peak memory of rank 0's device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist


def scene(rng, size):
    coarse = rng.standard_normal((1, 3, 16, 16)).repeat(size // 16, 2).repeat(size // 16, 3)
    img = 0.5 + 0.15 * coarse
    for _ in range(40):
        y0, x0 = rng.integers(0, size - size // 8, 2)
        hh, ww = rng.integers(size // 64, size // 8, 2)
        img[0, :, y0 : y0 + hh, x0 : x0 + ww] = rng.random(3)[:, None, None]
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def circ_blur(img, k):
    kh = k.shape[-1]
    kpad = np.zeros(img.shape[-2:], np.float32)
    kpad[:kh, :kh] = k[0, 0]
    kpad = np.roll(kpad, (-(kh // 2), -(kh // 2)), axis=(0, 1))
    return np.fft.irfft2(
        np.fft.rfft2(img, axes=(2, 3)) * np.fft.rfft2(kpad, s=img.shape[-2:]),
        s=img.shape[-2:], axes=(2, 3),
    ).astype(np.float32)


def card_name_and_power_limit(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(dev.index)], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Spatially split 4096^2 deblur (BASELINE config 5)")
    p.add_argument("--platform", default=None, help="the JAX flag's name for --device")
    p.add_argument("--device", default=None,
                   help="cuda (the default: one GPU per rank, NCCL) or cpu (gloo)")
    p.add_argument("--size", type=int, default=4096)
    p.add_argument("--maxit", type=int, default=50)
    p.add_argument("--halo", type=int, default=32)
    p.add_argument("--x_update_mode", choices=["pencil", "halo"], default="halo")
    p.add_argument("--lmbd", type=float, default=0.002)
    p.add_argument("--rho", type=float, default=0.5)
    p.add_argument("--skip_oracle", action="store_true",
                   help="skip the unsharded oracle check (timing-only run)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from torch_admm_deconv_tpu_torch.data.transforms import gaussian_psf_np
    from torch_admm_deconv_tpu_torch.metrics.functional import psnr_np as psnr
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv
    from torch_admm_deconv_tpu_torch.parallel import (
        gather_rows,
        init_distributed,
        make_mesh,
        shard_rows,
        spatial_admm_tv,
    )
    from torch_admm_deconv_tpu_torch.utils.profiling import timed_fetch

    rank, n = init_distributed(device=args.device or args.platform)
    try:
        dev = torch.device("cpu") if dist.get_backend() == "gloo" else torch.device(
            "cuda", torch.cuda.current_device())
        mesh = make_mesh((n,), ("space",))
        rng = np.random.default_rng(0)
        t0 = time.time()
        clean = scene(rng, args.size)
        kern = gaussian_psf_np(9, 1.5)[None, None]
        noisy = np.clip(circ_blur(clean, kern) + 0.005 * rng.standard_normal(clean.shape), 0,
                        1).astype(np.float32)
        if rank == 0:
            print(f"[mp] built {args.size}^2 scene in {time.time() - t0:.1f}s; mesh = {n} shards",
                  file=sys.stderr, flush=True)
        x = shard_rows(torch.from_numpy(noisy), mesh).to(dev)
        kt = torch.from_numpy(kern).to(dev)

        def solve(v):
            return spatial_admm_tv(v, args.lmbd, args.rho, kt, iso=False, maxit=args.maxit,
                                   mesh=mesh, x_update_mode=args.x_update_mode, halo=args.halo)

        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        out = gather_rows(solve(x), mesh).cpu().numpy()
        if rank == 0:
            print(f"[mp] sharded solve (first call): {time.time() - t0:.1f}s", file=sys.stderr,
                  flush=True)
        # best of 3, each ending in a synchronize and a 4-byte copy to the
        # host: the checksum depends on the whole solve
        t = timed_fetch(lambda v: solve(v).sum(), x, reps=3)
        if rank == 0:
            print(json.dumps({
                "metric": f"megapixel_{args.size}x{args.size}_spatial_{args.x_update_mode}_{n}shards",
                "value": args.maxit / t,
                "unit": "iterations/s",
                "solve_s": t,
                "halo": args.halo,
                "psnr_blurred": psnr(noisy, clean),
                "psnr_restored": psnr(out, clean),
            }), flush=True)

            if not args.skip_oracle:
                full = torch.from_numpy(noisy).to(dev)

                def oracle(v):
                    return admm_tv(v, args.lmbd, args.rho, kt, iso=False, maxit=args.maxit,
                                   device=dev)

                t0 = time.time()
                ref = oracle(full).cpu().numpy()
                print(f"[mp] unsharded oracle: {time.time() - t0:.1f}s", file=sys.stderr,
                      flush=True)
                print(json.dumps({
                    "metric": "megapixel_max_err_vs_unsharded_oracle",
                    "value": float(np.max(np.abs(out - ref))),
                    "unit": "max abs err",
                    "psnr_oracle": psnr(ref, clean),
                    "agreement_psnr_db": psnr(out, ref),
                    # the unsharded solve on rank 0's device, timed as the sharded one
                    "oracle_solve_s": timed_fetch(lambda v: oracle(v).sum(), full, reps=3),
                }), flush=True)
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
            print(json.dumps({
                "metric": "megapixel_device",
                "card": card_name_and_power_limit(dev),
                "ranks": n,
                "peak_memory_bytes_rank0": peak,
            }), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
