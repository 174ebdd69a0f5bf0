"""Restore a file or a folder of degraded images of any size.

    python -m torch_admm_deconv_tpu_torch.scripts.infer --input photos/ --output out/ \
        --model classical --lmbd 0.05 --rho 1.0 --maxit 100 [--aniso] [--device cpu]
    python -m torch_admm_deconv_tpu_torch.scripts.infer --input noisy.png --output out/ \
        --model divergent --ckpt <checkpoint .tar>

Counterpart of the JAX package's ``scripts/infer.py`` (:43-103), with its
flags, plus ``--device cuda|cpu`` (the GPU by default; without one it
raises). Images go through the overlap-discard tiler (``infer.py``) in
batches of ``--max_batch`` tiles, with the classical TV-ADMM solver or a
checkpoint of the port's trainer (the flagship DivergentRestorer). For
each batch the script prints the path its solves took: the whole-solve
kernel K2, or the FFT loop. The default (isotropic 'compat' TV at batch 8)
takes the loop, as in the JAX package: 'compat' couples the tiles of a
batch, which the kernel does not; ``--aniso`` takes K2. PIL is needed only
to read and write image files.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.data import gaussian_psf_np
from torch_admm_deconv_tpu_torch.infer import classical_restorer, model_restorer, restore_image
from torch_admm_deconv_tpu_torch.ops.solver import whole_solve_mode

IMG_EXTS = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff"}


def _load(path: Path) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("RGB")
    return np.asarray(im, np.float32).transpose(2, 0, 1) / 255.0


def _save(path: Path, chw: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(chw * 255.0, 0, 255).astype(np.uint8).transpose(1, 2, 0)
    Image.fromarray(arr).save(path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Restore images (any size) with TV-ADMM / trained model")
    p.add_argument("--input", required=True, help="image file or directory")
    p.add_argument("--output", required=True, help="output directory")
    p.add_argument("--model", default="classical", choices=["classical", "divergent"])
    p.add_argument("--ckpt", default=None, help="checkpoint for --model divergent")
    p.add_argument("--lmbd", type=float, default=0.05)
    p.add_argument("--rho", type=float, default=1.0)
    p.add_argument("--maxit", type=int, default=100)
    p.add_argument("--aniso", action="store_true", help="anisotropic TV (default isotropic)")
    p.add_argument("--psf_gaussian", nargs=2, type=float, default=None,
                   metavar=("SIZE", "SIGMA"),
                   help="non-blind deblur with a SIZE x SIZE gaussian PSF of std SIGMA "
                        "(classical model only); margin must cover the PSF radius + TV "
                        "diffusion")
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--margin", type=int, default=32)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--no_pallas", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def restorer(args, device=None):
    """The batch apply function the flags ask for, and the path its solves
    take at one batch of ``max_batch`` tiles: ``"K2 (<mode>)"`` for the
    whole-solve kernel (its plain version on the CPU), else ``"FFT loop"``."""
    dev = resolve_device(device)
    batch = (args.max_batch, 3, args.tile, args.tile)
    if args.model == "divergent":
        if not args.ckpt:
            sys.exit("--model divergent requires --ckpt")
        from torch_admm_deconv_tpu_torch.train import load_checkpoint

        state = load_checkpoint(args.ckpt, map_location=dev)["model_state_dict"]
        apply_fn = model_restorer(state, device=dev)
        # the flagship's two kernel-less isotropic 'compat' layers
        mode = whole_solve_mode(batch, torch.float32, None, True, "compat", use_pallas=True)
    else:
        kern = None
        if args.psf_gaussian:
            size, sigma = int(args.psf_gaussian[0]), float(args.psf_gaussian[1])
            kern = gaussian_psf_np(size, sigma).reshape(1, 1, size, size)
        apply_fn = classical_restorer(args.lmbd, args.rho, args.maxit, iso=not args.aniso,
                                      kern=kern, use_pallas=not args.no_pallas, device=dev)
        kern_t = None if kern is None else torch.from_numpy(kern)
        mode = whole_solve_mode(batch, torch.float32, kern_t, not args.aniso, "compat",
                                use_pallas=not args.no_pallas)
    return apply_fn, "FFT loop" if mode is None else f"K2 ({'aniso' if args.aniso else mode})"


def serve(img: np.ndarray, apply_fn, path: str, args):
    """Restore one (C, H, W) image; returns the output and the path of each
    batch of tiles, in order."""
    batches = []

    def counted(batch):
        batches.append(path)
        return apply_fn(batch)

    out = restore_image(counted, img, tile=args.tile, margin=args.margin,
                        max_batch=args.max_batch)
    return out, batches


def main(argv=None):
    args = build_parser().parse_args(argv)
    src = Path(args.input)
    files = (sorted(q for q in src.iterdir() if q.suffix.lower() in IMG_EXTS)
             if src.is_dir() else [src])
    if not files:
        sys.exit(f"no images found under {src}")
    out_dir = Path(args.output)
    out_dir.mkdir(parents=True, exist_ok=True)
    apply_fn, path = restorer(args, args.device)

    for f in files:
        img = _load(f)
        t0 = time.perf_counter()
        out, batches = serve(img, apply_fn, path, args)
        dt = time.perf_counter() - t0
        dst = out_dir / (f.stem + "_restored.png")
        _save(dst, out)
        for i, taken in enumerate(batches):
            print(f"{f.name}: batch {i} of {args.max_batch} tiles of {args.tile}: {taken}")
        print(f"{f.name}: {img.shape[2]}x{img.shape[1]} -> {dst} ({dt:.2f}s)")


if __name__ == "__main__":
    main()
