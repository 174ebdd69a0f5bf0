"""Single-image anchor: a trained DivergentRestorer checkpoint beside the
classical TV-ADMM solver on one noisy crop.

    python -m torch_admm_deconv_tpu_torch.scripts.single_image_anchor \
        --ckpt <checkpoint .tar> [--image clean.png] [--model_cfg cfg.json] [--device cpu]

Counterpart of the JAX package's ``scripts/single_image_anchor.py``, flag
for flag, with ``--device cuda|cpu`` in place of ``tpu|cpu`` (the GPU by
default; without one it raises) and ``--save_path`` defaulting to
``eval_out/single_image_anchor``. Protocol: the centre 256x256 crop of one
clean image, AWGN sigma ``--awgn``/255 from ``numpy`` seed ``--seed``; the
checkpoint's model (the flagship, or the ``DivergentRestorer`` of
``--model_cfg``) with its two ADMM layers on the whole-solve kernel K2, and
``admm_tv(iso=True, maxit=100)`` at ``--lmbd`` and ``--rho``, which takes
the FFT loop, as in JAX. ``anchor`` takes arrays and returns the outputs and
each column's PSNR and SSIM; ``main`` reads the image and writes the PNGs
and ``summary.md`` (PIL, imported there).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.metrics import functional as F
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv

CROP = 256
COLUMNS = ("noisy", "model", "admm")


def build_model(model_cfg=None, device=None):
    """The flagship (``remat=False, use_pallas=True``), or with ``model_cfg``
    (a dict: level_branches, filters, attention_reduction, admm_iters) the
    DivergentRestorer the JAX script builds from it."""
    from torch_admm_deconv_tpu_torch.models.denoiser import (
        DivergentRestorer,
        flagship_divergent_restorer,
    )

    dev = resolve_device(device)
    if not model_cfg:
        return flagship_divergent_restorer(remat=False, use_pallas=True, device=dev)
    admm = {"kern_size": (), "max_iters": model_cfg.get("admm_iters", 100), "iso": True,
            "remat": False, "use_pallas": True}
    filters = model_cfg.get("filters", 86)
    return DivergentRestorer(
        level_branches=model_cfg.get("level_branches", [2, 8, 32]), in_channels=3,
        final_channels=3, filters=filters, gate_channels=filters,
        attention_reduction=model_cfg.get("attention_reduction", 8),
        output_activation=torch.sigmoid, admms=[dict(admm), dict(admm)], device=dev,
    )


def load_model(ckpt, model_cfg=None, device=None):
    """``build_model`` with the state dict of a checkpoint of the port's
    trainer, in eval mode."""
    from torch_admm_deconv_tpu_torch.train import load_checkpoint

    dev = resolve_device(device)
    model = build_model(model_cfg, dev)
    model.load_state_dict(load_checkpoint(ckpt, map_location=dev)["model_state_dict"])
    return model.eval()


def center_crop(img_hwc: np.ndarray, size: int = CROP) -> np.ndarray:
    """(1, C, size, size) from the centre of an (H, W, C) image."""
    h, w = img_hwc.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img_hwc[top : top + size, left : left + size].transpose(2, 0, 1)[None]


def add_noise(clean: np.ndarray, awgn: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(
        clean + (awgn / 255.0) * rng.standard_normal(clean.shape), 0.0, 1.0
    ).astype(np.float32)


def anchor(clean: np.ndarray, noisy: np.ndarray, model, lmbd: float, rho: float, device=None):
    """The model and admm columns on one (1, 3, H, W) noisy image:
    ``(outs, rows)``, ``outs`` the numpy outputs by column (with the noisy
    input), ``rows`` ``{"method", "psnr", "ssim"}`` for each column."""
    dev = resolve_device(device)
    y = torch.from_numpy(np.ascontiguousarray(clean, np.float32)).to(dev)
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(noisy, np.float32)).to(dev)
        outs = {
            "model": model(x).cpu().numpy(),
            "admm": admm_tv(x, lmbd, rho, None, iso=True, maxit=100, device=dev).cpu().numpy(),
            "noisy": noisy,
        }
        rows = []
        for name in COLUMNS:
            out = torch.from_numpy(np.ascontiguousarray(outs[name])).to(dev)
            rows.append({"method": name, "psnr": float(F.psnr(out, y)),
                         "ssim": float(F.ssim(out, y))})
    return outs, rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--image", default=None,
                    help="clean image (default: first eval tile, held out)")
    ap.add_argument("--save_path", default="eval_out/single_image_anchor")
    ap.add_argument("--awgn", type=float, default=15.0)
    ap.add_argument("--lmbd", type=float, default=0.2)
    ap.add_argument("--rho", type=float, default=0.5,
                    help="classical-solver params (grid-sweep best)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model_cfg", default=None,
                    help="json with level_branches/filters/... for the ckpt "
                         "model (default: the flagship)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    from PIL import Image

    dev = resolve_device(args.device)
    img_path = args.image
    if img_path is None:
        img_path = sorted(Path("datasets/local_clean/eval").glob("*.png"))[0]
    clean = center_crop(np.asarray(Image.open(img_path).convert("RGB"), np.float32) / 255.0)
    noisy = add_noise(clean, args.awgn, args.seed)
    cfg = json.loads(Path(args.model_cfg).read_text()) if args.model_cfg else None
    model = load_model(args.ckpt, cfg, dev)
    outs, rows = anchor(clean, noisy, model, args.lmbd, args.rho, dev)

    save = Path(args.save_path)
    save.mkdir(parents=True, exist_ok=True)

    def png(name, chw):
        arr = np.clip(chw[0] * 255.0, 0, 255).astype(np.uint8).transpose(1, 2, 0)
        Image.fromarray(arr).save(save / f"{name}.png")

    png("clean", clean)
    lines = [
        "# Single-image anchor (test_train.ipynb cells 30-34 protocol)",
        "",
        f"image: `{img_path}` (center 256^2 crop), AWGN sigma={args.awgn}/255, "
        f"seed {args.seed}; checkpoint `{args.ckpt}`.",
        "",
        "| method | PSNR (dB) | SSIM |",
        "|---|---|---|",
    ]
    for row in rows:
        png(row["method"], outs[row["method"]])
        lines.append(f"| {row['method']} | {row['psnr']:.2f} | {row['ssim']:.4f} |")
        print(f"{row['method']}: PSNR={row['psnr']:.2f} dB SSIM={row['ssim']:.4f}")
    lines += [
        "",
        "Reference notebook numbers on its 'house' image (different image, "
        "not directly comparable): model 26.19 dB / FFDNet 30.41 / BM3D "
        "34.83 (test_train.ipynb cells 32-34). This script runs neither "
        "FFDNet nor BM3D.",
    ]
    (save / "summary.md").write_text("\n".join(lines) + "\n")
    print(f"wrote {save}/summary.md")


if __name__ == "__main__":
    main()
