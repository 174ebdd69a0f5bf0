"""Megapixel demo: a large image's rows split over the ranks, restored by the
distributed TV-ADMM solver (halo-exchange shifts and the pencil FFT).

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m torch_admm_deconv_tpu_torch.examples.megapixel_demo [--size 2048] \
        [--maxit 50] [--adaptive] [--device cpu] [--save out.npy]

Counterpart of the JAX package's ``examples/megapixel_demo.py``, with
``--device`` in place of ``--platform``: the GPU by default (one per rank,
NCCL; without one it raises), gloo ranks on the CPU only with ``--device
cpu``. Every rank builds the same seeded checkerboard with AWGN (sigma
0.05) and solves its rows over a ``space`` mesh of all ranks: a fixed
``--maxit``-iteration solve, or with ``--adaptive`` the residual-stopped
solve to tol 1e-4. Rank 0 prints the lines, and with ``--save`` writes the
restored image as a .npy file. ``main`` returns the readings (ranks,
iterations, residual, seconds, both PSNRs).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

LMBD, RHO, TOL = 0.05, 1.0, 1e-4


def scene(size: int):
    """(clean, noisy) (size, size) float: a checkerboard of 128-pixel
    squares and its AWGN copy from ``numpy`` seed 0."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:size, 0:size]
    img = 0.3 + 0.4 * ((yy // 128 + xx // 128) % 2)
    noisy = np.clip(img + 0.05 * rng.normal(size=img.shape), 0, 1).astype(np.float32)
    return img, noisy


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=2048)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda: one GPU per rank over NCCL; cpu: gloo ranks")
    parser.add_argument("--maxit", type=int, default=50)
    parser.add_argument("--adaptive", action="store_true")
    parser.add_argument("--save", default=None,
                        help="write the restored image (rank 0) to this .npy file")
    args = parser.parse_args(argv)

    from torch_admm_deconv_tpu_torch.metrics.functional import psnr_np as psnr
    from torch_admm_deconv_tpu_torch.parallel import (
        gather_rows,
        init_distributed,
        make_mesh,
        shard_rows,
        spatial_admm_tv,
        spatial_admm_tv_adaptive,
    )

    rank, n = init_distributed(device=args.device)
    try:
        dev = torch.device("cpu") if args.device == "cpu" else torch.device(
            "cuda", torch.cuda.current_device())
        mesh = make_mesh((n,), ("space",))
        say = print if rank == 0 else (lambda *a, **k: None)
        say(f"devices: {n} x {dev.type}")

        h = w = args.size
        assert h % n == 0
        img, noisy = scene(h)
        x = shard_rows(torch.from_numpy(noisy[None, None]), mesh).to(dev)

        t0 = time.time()
        with torch.inference_mode():
            if args.adaptive:
                res = spatial_admm_tv_adaptive(x, LMBD, RHO, None, maxit=args.maxit, tol=TOL,
                                               mesh=mesh)
                out = gather_rows(res.x, mesh).cpu().numpy()
                iters, r_norm = int(res.iters), float(res.r_norm)
                say(f"adaptive spatial solve: {iters} iters, r={r_norm:.2e}, "
                    f"{time.time() - t0:.1f}s (incl. first-call costs)")
            else:
                out = gather_rows(spatial_admm_tv(x, LMBD, RHO, None, maxit=args.maxit,
                                                  mesh=mesh), mesh).cpu().numpy()
                iters, r_norm = args.maxit, None
                say(f"fixed spatial solve: {args.maxit} iters, {time.time() - t0:.1f}s "
                    f"(incl. first-call costs)")
        solve_s = time.time() - t0
        result = {"ranks": n, "iters": iters, "r_norm": r_norm, "solve_s": solve_s,
                  "psnr_noisy": psnr(noisy, img), "psnr_restored": psnr(out[0, 0], img)}
        say(f"PSNR {result['psnr_noisy']:.2f} -> {result['psnr_restored']:.2f} dB on {h}x{w}",
            flush=True)
        if args.save and rank == 0:
            np.save(args.save, out[0, 0])
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
