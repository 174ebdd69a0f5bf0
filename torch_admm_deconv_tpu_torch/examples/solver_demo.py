"""Solver demo: blur and noise an image, restore it with the classical
TV-ADMM solver given the matching PSF, report the PSNR before and after.

    python -m torch_admm_deconv_tpu_torch.examples.solver_demo [image.png] \
        [--out solver_demo_out] [--device cpu]

Counterpart of the JAX package's ``examples/solver_demo.py``, with
``--device cuda|cpu`` (the GPU by default; without one it raises). Without
an input it uses a synthetic piecewise-smooth image. ``run`` takes the clean
(C, H, W) array and returns the readings; PIL is needed only to read an
input image and write the PNGs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.data.transforms import gaussian_psf_np
from torch_admm_deconv_tpu_torch.metrics.functional import psnr_np as psnr
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv, admm_tv_adaptive

LMBD, RHO, TOL = 0.002, 0.5, 1e-4
PSF = (7, 1.5)  # size, sigma


def synthetic_image(h=256, w=256):
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.25 + 0.5 * ((yy > h // 3) & (xx > w // 4))
    img = img + 0.2 * (((yy - h / 2) ** 2 + (xx - w / 2) ** 2) < (h / 4) ** 2)
    return np.clip(np.stack([img, img * 0.9, img * 0.8]), 0, 1).astype(np.float32)


def htran(x, kern):
    """H^T as circular correlation with the flipped PSF, half-pad centred:
    out[i, j] = sum_{a,b} kflip[a, b] x[(i + a - top) % H, (j + b - left) % W]
    with top = (kh - 1) // 2, left = (kw - 1) // 2. Given the flipped PSF
    it is the circular blur by the PSF."""
    k = np.asarray(kern).reshape(kern.shape[-2], kern.shape[-1])
    kflip = k[::-1, ::-1]
    kh, kw = kflip.shape
    top, left = (kh - 1) // 2, (kw - 1) // 2
    out = np.zeros_like(x)
    for a in range(kh):
        for b in range(kw):
            out += kflip[a, b] * np.roll(x, (top - a, left - b), axis=(-2, -1))
    return out


def run(clean: np.ndarray, maxit: int = 300, sigma_noise: float = 0.01, device=None) -> dict:
    """Blur ``clean`` (C, H, W) by the 7x7 Gaussian ``PSF``, add AWGN from
    ``numpy`` seed 0, and restore it with ``admm_tv(iso=True)`` for
    ``maxit`` iterations and with ``admm_tv_adaptive`` to tol 1e-4."""
    dev = resolve_device(device)
    psf = gaussian_psf_np(*PSF)[None, None]
    blurred = htran(clean[None], np.flip(psf, axis=(-2, -1)))[0]
    rng = np.random.default_rng(0)
    noisy = np.clip(blurred + sigma_noise * rng.normal(size=blurred.shape), 0, 1).astype(
        np.float32
    )
    xin = torch.from_numpy(noisy[None]).to(dev)
    kern = torch.from_numpy(psf).to(dev)
    with torch.inference_mode():
        restored = admm_tv(xin, LMBD, RHO, kern, iso=True, maxit=maxit, device=dev)[0].cpu().numpy()
        res = admm_tv_adaptive(xin, LMBD, RHO, kern, tol=TOL, maxit=maxit, device=dev)
    adaptive = res.x[0].cpu().numpy()
    return {"noisy": noisy, "restored": restored, "adaptive": adaptive,
            "psnr_degraded": psnr(noisy, clean), "psnr_restored": psnr(restored, clean),
            "psnr_adaptive": psnr(adaptive, clean), "adaptive_iters": int(res.iters),
            "adaptive_r": float(res.r_norm), "adaptive_s": float(res.s_norm)}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("image", nargs="?", default=None)
    parser.add_argument("--out", default="solver_demo_out")
    parser.add_argument("--maxit", type=int, default=300)
    parser.add_argument("--sigma_noise", type=float, default=0.01)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)

    if args.image:
        from PIL import Image

        arr = np.asarray(Image.open(args.image).convert("RGB"), np.float32) / 255.0
        clean = arr.transpose(2, 0, 1)
    else:
        clean = synthetic_image()
    r = run(clean, args.maxit, args.sigma_noise, args.device)

    print(f"degraded PSNR:  {r['psnr_degraded']:.2f} dB")
    print(f"restored PSNR:  {r['psnr_restored']:.2f} dB ({args.maxit} fixed iters)")
    print(
        f"adaptive:       {r['psnr_adaptive']:.2f} dB "
        f"({r['adaptive_iters']} iters to r={r['adaptive_r']:.1e})"
    )

    from PIL import Image

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for name, im in [("clean", clean), ("degraded", r["noisy"]), ("restored", r["restored"])]:
        Image.fromarray(
            (np.clip(im, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)
        ).save(out / f"{name}.png")
    print(f"images written to {out}")


if __name__ == "__main__":
    main()
