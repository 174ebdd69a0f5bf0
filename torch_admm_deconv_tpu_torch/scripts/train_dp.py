"""Data-parallel training of the unrolled learned-prox ADMM (BASELINE
config 4: "unrolled learned-ADMM (prox net z-update) training ...
data-parallel across hosts").

    python -m torch.distributed.run --standalone --nproc_per_node=N \
        -m torch_admm_deconv_tpu_torch.scripts.train_dp [--device cpu] [--epochs 30]

Counterpart of the JAX package's ``scripts/train_dp.py``, flag for flag, plus
``--device`` (the GPU by default, one per rank, over NCCL; gloo with
``--device cpu``; ``--platform`` is the JAX flag's name for it). Trains
``default_learned_prox`` (``--steps`` stages, hidden 32) with
``SSIMLabColorLoss`` and AdamW at a constant ``--lr`` through
``parallel.make_dp_train_step``: the model is replicated by DDP over a
``data`` mesh of every rank, and each rank takes its
``process_batch_bounds`` rows of the same seeded global batch, so the union
over the ranks is the batch one process would draw. The default is the
non-blind deblur protocol: a 9x9 Gaussian PSF of sigma 1.5 applied
circularly, then AWGN of sigma 5/255; ``--blur_gaussian 0`` is the
denoising protocol. Rank 0 evaluates after each epoch (loss and PSNR from
the mean MSE) and saves the best checkpoint through ``NNSaver``; the printed
train losses are global means.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from torch_admm_deconv_tpu_torch.data import (
    AddAWGN,
    CircBlur,
    DataLoader,
    ImageDataset,
    RandCrop,
    Scale,
    gaussian_psf_np,
)
from torch_admm_deconv_tpu_torch.metrics import SSIMLabColorLoss
from torch_admm_deconv_tpu_torch.models.learned_prox import default_learned_prox
from torch_admm_deconv_tpu_torch.parallel import (
    init_distributed,
    make_dp_train_step,
    make_mesh,
    process_batch_bounds,
    shard_host_batch,
)
from torch_admm_deconv_tpu_torch.train import NNSaver, make_optimizer


def protocol_psf(blur_gaussian: float, blur_ksize: int):
    """The deblur protocol's PSF, or None for the denoising protocol."""
    return gaussian_psf_np(blur_ksize, blur_gaussian) if blur_gaussian > 0 else None


def make_transforms(crop: int, blur_gaussian: float, blur_ksize: int, awgn: int) -> list:
    """Random crop, scale to [0, 1], the circular blur, then AWGN of sigma
    ``awgn``/255 (JAX train_dp.py:84-91)."""
    transforms = [RandCrop(crop), Scale()]
    psf = protocol_psf(blur_gaussian, blur_ksize)
    if psf is not None:
        transforms.append(CircBlur(psf))
    if awgn > 0:
        transforms.append(AddAWGN(std_range=(awgn, awgn + 1)))
    return transforms


def build_model(steps: int = 10, blur_gaussian: float = 1.5, blur_ksize: int = 9, *,
                device=None, generator=None):
    """``default_learned_prox`` for the protocol: the fixed PSF of the
    deblur protocol (no ``w``), or none for denoising (JAX
    train_dp.py:98-100)."""
    psf = protocol_psf(blur_gaussian, blur_ksize)
    return default_learned_prox(kern=blur_ksize if psf is not None else 0, steps=steps, psf=psf,
                                device=device, generator=generator)


def log0(*parts) -> None:
    """Print on rank 0 only."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*parts, flush=True)


def run_training(model, train_loader, eval_loader, lr: float, epochs: int,
                 saver: Optional[NNSaver], global_batch: int, mesh) -> dict:
    """Train ``model`` data-parallel over ``mesh``'s ``data`` axis as the
    script does, and return the history: per epoch the global-mean train
    loss, the step count, rank 0's eval loss and PSNR; every step's loss and
    wall time (each step ends in a host read of its loss); the best eval
    loss. ``saver`` is used on rank 0 only (None: no checkpoints)."""
    rank = dist.get_rank()
    rows = process_batch_bounds(global_batch)
    loss_fn = SSIMLabColorLoss()
    step = make_dp_train_step(model, make_optimizer(lr), loss_fn, mesh, axis="data")
    history = {"train_loss": [], "steps": [], "eval_loss": [], "eval_psnr": [], "step_loss": [],
               "step_s": [], "best": float("inf")}
    for epoch in range(epochs):
        t0 = time.time()
        n_steps, train_loss = 0, 0.0
        for x, y in train_loader:
            if x.shape[0] != global_batch:
                continue  # keep one batch shape
            xs, ys = shard_host_batch(x[rows], mesh), shard_host_batch(y[rows], mesh)
            t_step = time.perf_counter()
            lv = step(xs, ys, lr)
            history["step_s"].append(time.perf_counter() - t_step)
            history["step_loss"].append(lv)
            train_loss += lv
            n_steps += 1
        history["train_loss"].append(train_loss / max(n_steps, 1))
        history["steps"].append(n_steps)
        if rank == 0:
            # eval: loss and PSNR from the mean MSE (the reference's epoch metric)
            ev_loss, ev_mse, n_ev = 0.0, 0.0, 0
            model.eval()
            with torch.no_grad():
                for x, y in eval_loader:
                    xt, yt = shard_host_batch(x, mesh), shard_host_batch(y, mesh)
                    out = model(xt)
                    ev_loss += float(loss_fn(out, yt))
                    ev_mse += float(torch.mean((out - yt) ** 2))
                    n_ev += 1
            model.train()
            ev_loss /= n_ev
            psnr = 10 * np.log10(1.0 / (ev_mse / n_ev))
            history["eval_loss"].append(ev_loss)
            history["eval_psnr"].append(psnr)
            print(f"[dp] epoch {epoch}: train_loss {history['train_loss'][-1]:.4f} "
                  f"({n_steps} dp steps), eval_loss {ev_loss:.4f}, eval_psnr {psnr:.2f} dB, "
                  f"{time.time() - t0:.1f}s", flush=True)
            if ev_loss < history["best"]:
                history["best"] = ev_loss
                if saver is not None:
                    saver.save_model(epoch, model.state_dict(), step.optimizer.state_dict(),
                                     ev_loss)
        dist.barrier()
    log0(f"[dp] done; best eval loss {history['best']:.4f}")
    return history


def main(argv=None):
    p = argparse.ArgumentParser(description="Data-parallel learned-prox ADMM training")
    p.add_argument("--platform", default=None, help="the JAX flag's name for --device")
    p.add_argument("--device", default=None,
                   help="cuda (the default: one GPU per rank, NCCL) or cpu (gloo)")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=8.8e-4)
    p.add_argument("--global_batch", type=int, default=8,
                   help="split over the ranks; must divide by their number")
    p.add_argument("--train_dir", default="datasets/local_clean/train")
    p.add_argument("--eval_dir", default="datasets/local_clean/eval")
    p.add_argument("--crop", type=int, default=256)
    p.add_argument("--blur_gaussian", type=float, default=1.5,
                   help="deblur protocol PSF sigma (0 = denoise protocol)")
    p.add_argument("--blur_ksize", type=int, default=9)
    p.add_argument("--awgn", type=int, default=5)
    p.add_argument("--steps", type=int, default=10, help="unrolled ADMM stages")
    p.add_argument("--save_dir", default="trained_models")
    p.add_argument("--model_name", default="learned_prox_deblur_dp")
    args = p.parse_args(argv)

    rank, world = init_distributed(device=args.device or args.platform)
    try:
        mesh = make_mesh((world,), ("data",))
        process_batch_bounds(args.global_batch)  # the divisibility check, before any work
        log0(f"[dp] mesh: {world} ranks on axis 'data' ({dist.get_backend()}); global batch "
             f"{args.global_batch} ({args.global_batch // world}/rank)")
        dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device("cpu")
        transforms = make_transforms(args.crop, args.blur_gaussian, args.blur_ksize, args.awgn)
        train_dset = ImageDataset(Path(args.train_dir), Path(args.train_dir), transforms=transforms)
        eval_dset = ImageDataset(Path(args.eval_dir), Path(args.eval_dir), transforms=transforms)
        train_loader = DataLoader(train_dset, batch_size=args.global_batch, shuffle=True)
        eval_loader = DataLoader(eval_dset, batch_size=1, shuffle=False, seed=0, drop_last=False)
        model = build_model(args.steps, args.blur_gaussian, args.blur_ksize, device=dev,
                            generator=torch.Generator().manual_seed(0))
        saver = NNSaver(args.save_dir, args.model_name) if rank == 0 else None
        run_training(model, train_loader, eval_loader, args.lr, args.epochs, saver,
                     args.global_batch, mesh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
