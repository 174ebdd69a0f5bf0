"""Classical-solver rho/lambda grid sweep with PSNR/SSIM eval (BASELINE.json
config 3: "batched deconv sweep over rho/lambda grid, PSNR/SSIM eval").

    python -m torch_admm_deconv_tpu_torch.scripts.grid_sweep --y_dir clean/ \
        [--mode deblur] [--awgn 5] [--device cpu]

Counterpart of the JAX package's ``scripts/grid_sweep.py``, flag for flag,
with ``--device cuda|cpu`` in place of ``tpu|cpu`` (the GPU by default;
without one it raises). No training: this is the classical TV-ADMM quality
anchor. Two degradations (``degrade``):

* ``denoise``: AWGN sigma/255, no kernel (pure TV denoising);
* ``deblur``: a 9x9 Gaussian PSF (sigma 1.5) circular blur + AWGN.

``sweep`` solves the whole eval set as one batch at every grid point with
isotropic 'compat' TV (its norm couples the batch, as in JAX, so a row
depends on which images share the batch), clips to [0, 1] and scores the
mean SSIM/UIQ/SCC and the PSNR of the mean MSE. The FFT loop runs every
point, as in JAX (``admm_tv`` without ``use_pallas``); lambda and rho are
tensors on the device and the batch, the clean images and the PSF are put
there once. ``main`` writes ``grid_<mode>_awgn<N>.csv`` and prints the
best cell. PIL is needed only to read the image folder.
"""

from __future__ import annotations

import argparse
import csv
import time
from pathlib import Path

import numpy as np
import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.data.transforms import gaussian_psf_np
from torch_admm_deconv_tpu_torch.metrics import functional as F
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv

DEBLUR_PSF = (9, 1.5)  # size, sigma


def degrade(clean: np.ndarray, mode: str, awgn: float, crop: int, seed: int):
    """The sweep's input batch from the clean (N, C, crop, crop) images:
    ``(noisy, kern)``, ``kern`` the (1, 1, 9, 9) float32 deblur PSF or None.
    Deblurring blurs circularly by ``rfft2`` with the centred PSF; then
    AWGN ``awgn``/255 from ``numpy`` seed ``seed`` and a clip to [0, 1]."""
    rng = np.random.default_rng(seed)
    kern = None
    degraded = clean
    if mode == "deblur":
        size, sigma = DEBLUR_PSF
        k = gaussian_psf_np(size, sigma)
        kern = k[None, None]
        c = size // 2
        K = np.fft.rfft2(np.roll(np.pad(k, ((0, crop - size),) * 2), (-c, -c), (0, 1)))
        degraded = np.fft.irfft2(
            np.fft.rfft2(clean, axes=(2, 3)) * K, s=clean.shape[2:], axes=(2, 3)
        ).astype(np.float32)
    elif mode != "denoise":
        raise ValueError(f"mode must be 'denoise' or 'deblur', got {mode!r}")
    noisy = np.clip(
        degraded + (awgn / 255.0) * rng.standard_normal(degraded.shape), 0.0, 1.0
    ).astype(np.float32)
    return noisy, kern


def solve_and_score(x, y, kern, lmbd, rho, maxit: int) -> torch.Tensor:
    """One grid point on the device: (SSIM, UIQ, SCC, mean MSE) of the
    clipped iso 'compat' solve of the whole batch."""
    out = torch.clamp(admm_tv(x, lmbd, rho, kern, iso=True, maxit=maxit, device=x.device),
                      0.0, 1.0)
    per_im_mse = torch.mean((out - y) ** 2, dim=(1, 2, 3))
    return torch.stack([F.ssim(out, y), F.uiq(out, y), F.scc(out, y), torch.mean(per_im_mse)])


def sweep(clean: np.ndarray, noisy: np.ndarray, kern, lmbds, rhos, maxit: int, device=None):
    """Rows ``{lmbd, rho, scc, ssim, uiq, psnr_from_mean_mse}``, lambda in
    the outer loop, as the JAX script writes them."""
    dev = resolve_device(device)
    x = torch.from_numpy(np.ascontiguousarray(noisy, np.float32)).to(dev)
    y = torch.from_numpy(np.ascontiguousarray(clean, np.float32)).to(dev)
    kt = None if kern is None else torch.from_numpy(np.asarray(kern, np.float32)).to(dev)
    rows = []
    with torch.inference_mode():
        for lmbd in lmbds:
            for rho in rhos:
                scores = solve_and_score(x, y, kt, torch.tensor(float(lmbd), device=dev),
                                         torch.tensor(float(rho), device=dev), maxit)
                ssim, uiq, scc, mean_mse = scores.tolist()
                # the JAX script's column order: its jitted dict's keys, sorted
                rows.append({"lmbd": float(lmbd), "rho": float(rho), "scc": scc, "ssim": ssim,
                             "uiq": uiq,
                             "psnr_from_mean_mse": float(10.0 * np.log10(1.0 / mean_mse))})
    return rows


def write_csv(rows, path: Path) -> None:
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def summary_lines(rows, clean, noisy, mode: str, awgn: float, grid, wall: float, out_csv):
    """The script's three ``[grid]`` lines."""
    noisy_psnr = 10.0 * np.log10(1.0 / float(np.mean((noisy - clean) ** 2)))
    best = max(rows, key=lambda r: r["psnr_from_mean_mse"])
    return [
        f"[grid] {mode} awgn={awgn} images={clean.shape[0]} "
        f"grid={grid[0]}x{grid[1]} wall={wall:.1f}s -> {out_csv}",
        f"[grid] degraded input: PSNR={noisy_psnr:.3f} dB",
        f"[grid] best: lmbd={best['lmbd']} rho={best['rho']} "
        f"SSIM={best['ssim']:.4f} UIQ={best['uiq']:.4f} SCC={best['scc']:.4f} "
        f"PSNR(from mean MSE)={best['psnr_from_mean_mse']:.3f} dB",
    ]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="rho/lambda grid sweep")
    parser.add_argument("--y_dir", default="datasets/local_clean/eval")
    parser.add_argument("--save_path", default="eval_out/grid")
    parser.add_argument("--mode", choices=["denoise", "deblur"], default="denoise")
    parser.add_argument("--crop", type=int, default=256)
    parser.add_argument("--awgn", type=float, default=15.0)
    parser.add_argument("--maxit", type=int, default=100)
    parser.add_argument("--lmbd_grid", default="0.002,0.005,0.01,0.02,0.04,0.08,0.15")
    parser.add_argument("--rho_grid", default="0.05,0.1,0.25,0.5,1.0,2.0,4.0")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    from torch_admm_deconv_tpu_torch.data import DataLoader, ImageDataset, RandCrop, Scale

    # the whole eval set as one batch (deterministic crops)
    dset = ImageDataset(Path(args.y_dir), Path(args.y_dir),
                        transforms=[RandCrop(args.crop), Scale()])
    loader = DataLoader(dset, batch_size=1, shuffle=False, seed=args.seed, drop_last=False)
    clean = np.concatenate([np.asarray(y) for _, y in loader], axis=0)
    noisy, kern = degrade(clean, args.mode, args.awgn, args.crop, args.seed)

    lmbds = [float(v) for v in args.lmbd_grid.split(",")]
    rhos = [float(v) for v in args.rho_grid.split(",")]
    t0 = time.time()
    rows = sweep(clean, noisy, kern, lmbds, rhos, args.maxit, dev)
    wall = time.time() - t0

    save = Path(args.save_path)
    save.mkdir(parents=True, exist_ok=True)
    out_csv = save / f"grid_{args.mode}_awgn{int(args.awgn)}.csv"
    write_csv(rows, out_csv)
    for line in summary_lines(rows, clean, noisy, args.mode, args.awgn, (len(lmbds), len(rhos)),
                              wall, out_csv):
        print(line)


if __name__ == "__main__":
    main()
