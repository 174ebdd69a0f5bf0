"""Evaluate restoration methods on paired image folders.

    python -m torch_admm_deconv_tpu_torch.scripts.eval_algs --x_dir X --y_dir Y \
        --model classical [--blur_gaussian 1.5] [--nafnet_ckpt N.tar] [--device cpu]

Counterpart of the JAX package's ``scripts/eval_algs.py`` (:53-238), flag for
flag, except ``--device cuda|cpu`` (the GPU by default; without one it
raises). Each image is cropped (``RandCrop``), scaled to [0, 1], optionally
blurred circularly with a Gaussian PSF and given AWGN of sigma in
[awgn, awgn + 1)/255, at batch 1 in a fixed order (seed 0). Columns:

* ``model``: the flagship DivergentRestorer from a checkpoint of the port's
  trainer (``--ckpt``), its ADMM layers on the whole-solve kernel on the GPU;
* ``admm``: the classical TV-ADMM solver (isotropic TV denoising, or
  anisotropic with the true PSF under ``--blur_gaussian``), on the
  whole-solve kernel on the GPU;
* ``bm3d``: ``ops/bm3d.py`` on the host (not under the deblur protocol);
* ``nafnet``: a NAFNet checkpoint (``--nafnet_ckpt``), width
  ``--nafnet_width``, [2, 2, 4, 8] / 12 / [2, 2, 2, 2].

Per image and column it writes SSIM, PSNR, SCC, UIQ and MSE to
``metrics.csv`` and the clean, noisy and restored PNGs, then prints per
column the mean SSIM, UIQ and SCC and the PSNR of the mean MSE. PIL is
needed only to read and write image files; :func:`evaluate_pair` takes
arrays.
"""

from __future__ import annotations

import argparse
import csv
import json
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.metrics import functional as F

METRICS = {"ssim": F.ssim, "psnr": F.psnr, "scc": F.scc, "uiq": F.uiq, "mse": F.mse}
FIELDS = ["image", "method", *METRICS]


def _to_png(path: Path, chw: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(chw * 255.0, 0, 255).astype(np.uint8).transpose(1, 2, 0)
    Image.fromarray(arr.squeeze() if arr.shape[-1] == 1 else arr).save(path)


def model_column(ckpt, model_cfg: Optional[dict] = None, *, device=None) -> Callable:
    """The flagship (or the DivergentRestorer of ``model_cfg``) with the
    checkpoint's weights, no remat, its ADMM layers on the whole-solve
    kernel on the GPU."""
    from torch_admm_deconv_tpu_torch.models.denoiser import (
        DivergentRestorer,
        flagship_divergent_restorer,
    )
    from torch_admm_deconv_tpu_torch.train import load_checkpoint

    dev = resolve_device(device)
    use_pallas = dev.type == "cuda"
    if model_cfg:
        admm = {"kern_size": (), "max_iters": model_cfg.get("admm_iters", 100), "iso": True,
                "remat": False, "use_pallas": use_pallas}
        filters = model_cfg.get("filters", 86)
        model = DivergentRestorer(
            level_branches=model_cfg.get("level_branches", [2, 8, 32]), in_channels=3,
            final_channels=3, filters=filters, gate_channels=filters,
            attention_reduction=model_cfg.get("attention_reduction", 8),
            output_activation=torch.sigmoid, admms=[dict(admm), dict(admm)], device=dev)
    else:
        model = flagship_divergent_restorer(remat=False, use_pallas=use_pallas, device=dev)
    model.load_state_dict(load_checkpoint(ckpt, map_location=dev)["model_state_dict"])
    return model.eval()


def admm_column(lmbd: float, rho: float, maxit: int, psf: Optional[np.ndarray] = None, *,
                device=None) -> Callable:
    """The classical solver: isotropic TV denoising, or non-blind
    anisotropic TV deblurring with the true PSF; the whole-solve kernel on
    the GPU (at batch 1 the isotropic 'compat' norm runs as 'sample')."""
    from torch_admm_deconv_tpu_torch.ops.solver import admm_tv

    dev = resolve_device(device)
    kern = None if psf is None else torch.from_numpy(psf.reshape(1, 1, *psf.shape)).to(dev)
    return lambda x: admm_tv(x, lmbd, rho, kern, iso=kern is None, maxit=maxit,
                             use_pallas=dev.type == "cuda", device=dev)


def nafnet_column(ckpt, width: int = 64, *, device=None) -> Callable:
    """NAFNet in the comparison configuration, [2, 2, 4, 8] / 12 /
    [2, 2, 2, 2], with the checkpoint's weights."""
    from torch_admm_deconv_tpu_torch.models.nafnet import NAFNet
    from torch_admm_deconv_tpu_torch.train import load_checkpoint

    dev = resolve_device(device)
    model = NAFNet(img_channel=3, width=width, middle_blk_num=12, enc_blk_nums=(2, 2, 4, 8),
                   dec_blk_nums=(2, 2, 2, 2), device=dev)
    model.load_state_dict(load_checkpoint(ckpt, map_location=dev)["model_state_dict"])
    return model.eval()


def bm3d_column(x: torch.Tensor) -> np.ndarray:
    """The BM3D column on the host: estimate sigma, then denoise
    (ops/bm3d.py); (1, C, H, W) in and out."""
    from torch_admm_deconv_tpu_torch.ops.bm3d import bm3d, estimate_sigma

    hwc = x[0].cpu().numpy().transpose(1, 2, 0)
    out = bm3d(hwc, estimate_sigma(hwc, channel_axis=-1))
    return out.transpose(2, 0, 1)[None].astype(np.float32)


def evaluate_pair(x: np.ndarray, y: np.ndarray, columns: Dict[str, Callable], *, device=None):
    """Run every column on one degraded/clean pair, each (1, C, H, W)
    float32, and measure its output against the clean image. A column maps
    the degraded batch, on the device, to its restoration. Returns the
    outputs (numpy), one row per column (method and metrics) and each
    column's seconds (host clock, ending in a synchronize on the GPU)."""
    dev = resolve_device(device)
    xt, yt = torch.from_numpy(np.asarray(x)).to(dev), torch.from_numpy(np.asarray(y)).to(dev)
    outs, rows, seconds = {}, [], {}
    with torch.inference_mode():
        for name, fn in columns.items():
            t0 = time.perf_counter()
            out = torch.as_tensor(fn(xt), device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            seconds[name] = time.perf_counter() - t0
            values = torch.stack([m(out, yt).float() for m in METRICS.values()]).tolist()
            rows.append({"method": name, **dict(zip(METRICS, values))})
            outs[name] = out.cpu().numpy()
    return outs, rows, seconds


def summary(rows, seconds_per_image: float):
    """One line per method, as the notebook summarises: mean SSIM, UIQ, SCC
    and the PSNR of the mean MSE."""
    lines = []
    for method in sorted({r["method"] for r in rows}):
        sel = [r for r in rows if r["method"] == method]
        mean_mse = float(np.mean([r["mse"] for r in sel]))
        lines.append(
            f"{method}: SSIM={np.mean([r['ssim'] for r in sel]):.4f} "
            f"UIQ={np.mean([r['uiq'] for r in sel]):.4f} "
            f"SCC={np.mean([r['scc'] for r in sel]):.4f} "
            f"PSNR(from mean MSE)={10 * np.log10(1.0 / mean_mse):.3f} dB "
            f"({len(sel)} images, {seconds_per_image:.2f} s/image)")
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate restoration methods")
    parser.add_argument("--x_dir", required=True, help="degraded inputs dir")
    parser.add_argument("--y_dir", required=True, help="clean targets dir")
    parser.add_argument("--save_path", default="eval_out")
    parser.add_argument("--ckpt", default=None, help="trained model checkpoint (.tar)")
    parser.add_argument("--model", default="divergent",
                        choices=["divergent", "classical", "learned_prox"],
                        help="divergent: DivergentRestorer ckpt; classical: TV-ADMM solver; "
                             "learned_prox: not ported yet")
    parser.add_argument("--crop", type=int, default=256)
    parser.add_argument("--awgn", type=int, default=15, help="AWGN sigma added to x (0=off)")
    parser.add_argument("--lmbd", type=float, default=0.05)
    parser.add_argument("--rho", type=float, default=1.0)
    parser.add_argument("--maxit", type=int, default=100)
    parser.add_argument("--model_cfg", default=None,
                        help="json with level_branches/filters/... for the ckpt model")
    parser.add_argument("--nafnet_ckpt", default=None,
                        help="optional NAFNet comparison checkpoint (.tar)")
    parser.add_argument("--nafnet_width", type=int, default=64)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--lp_kern", type=int, default=0,
                        help="learned_prox PSF size (must match the ckpt)")
    parser.add_argument("--lp_psf_sigma", type=float, default=0.0,
                        help="learned_prox fixed-Gaussian PSF sigma (must match the ckpt)")
    parser.add_argument("--blur_gaussian", type=float, default=0.0,
                        help="Circularly blur inputs with a Gaussian PSF of this sigma "
                             "(deblur protocol); the classical solver then runs non-blind "
                             "with the true PSF")
    parser.add_argument("--blur_ksize", type=int, default=9)
    parser.add_argument("--bm3d", action=argparse.BooleanOptionalAction, default=True,
                        help="include the BM3D column (ops/bm3d.py); --no-bm3d skips it")
    args = parser.parse_args(argv)
    if args.model == "learned_prox":
        raise NotImplementedError(
            "--model learned_prox: not ported yet (ROADMAP.md, queue 1 item 6, the rest of "
            "the model zoo)")

    from torch_admm_deconv_tpu_torch.data import (
        AddAWGN,
        CircBlur,
        DataLoader,
        ImageDataset,
        RandCrop,
        Scale,
        gaussian_psf_np,
    )

    dev = resolve_device(args.device)
    save = Path(args.save_path)
    save.mkdir(parents=True, exist_ok=True)

    transforms = [RandCrop(args.crop), Scale()]
    psf = None
    if args.blur_gaussian > 0:
        psf = gaussian_psf_np(args.blur_ksize, args.blur_gaussian)
        transforms.append(CircBlur(psf))
    if args.awgn > 0:
        transforms.append(AddAWGN(std_range=(args.awgn, args.awgn + 1)))
    dset = ImageDataset(Path(args.x_dir), Path(args.y_dir), transforms=transforms)
    loader = DataLoader(dset, batch_size=1, shuffle=False, seed=0, drop_last=False)

    columns = {}
    if args.model == "divergent" and args.ckpt:
        model_cfg = json.loads(Path(args.model_cfg).read_text()) if args.model_cfg else None
        columns["model"] = model_column(args.ckpt, model_cfg, device=dev)
    else:
        columns["admm"] = admm_column(args.lmbd, args.rho, args.maxit, psf, device=dev)
    if args.nafnet_ckpt:
        columns["nafnet"] = nafnet_column(args.nafnet_ckpt, args.nafnet_width, device=dev)
    if args.bm3d and psf is None:
        # BM3D is a denoiser: the deblur protocol has no BM3D column
        columns["bm3d"] = bm3d_column

    rows = []
    t_start = time.time()
    for i, (x, y) in enumerate(loader):
        outs, image_rows, _ = evaluate_pair(x, y, columns, device=dev)
        _to_png(save / f"{i:03d}_clean.png", np.asarray(y[0]))
        _to_png(save / f"{i:03d}_noisy.png", np.asarray(x[0]))
        for row in image_rows:
            _to_png(save / f"{i:03d}_{row['method']}.png", outs[row["method"]][0])
            rows.append({"image": i, **row})
    wall = time.time() - t_start

    with open(save / "metrics.csv", "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=FIELDS)
        writer.writeheader()
        writer.writerows(rows)
    for line in summary(rows, wall / max(len(loader), 1)):
        print(line)


if __name__ == "__main__":
    main()
