"""Train the flagship restorer.

    python -m torch_admm_deconv_tpu_torch.scripts.train -c configs/train_cfg.json \
        -m 0 -M 15 [--device cpu]

Counterpart of the JAX package's ``scripts/train.py``, with the same flags
and JSON config (``configs/train_cfg.json``: image folders, batch sizes,
``im_shape``, lr, epochs, an optional ``model`` override and
``train.ckpt``). The model is the flagship DivergentRestorer ([2, 8, 32]
branches, 86 filters, sigmoid output, two kernel-less 100-iteration
isotropic ADMM layers), or with ``--arch nafnet`` the eval harness's NAFNet
comparison model ([2, 2, 4, 8] / 12 / [2, 2, 2, 2] at ``--nafnet_width``),
or with ``--arch learned_prox`` the unrolled learned-prox
ADMM of BASELINE.json config 4 (``default_learned_prox``: 10 shared stages,
hidden 32; ``--lp_kern N`` a PSF of N x N, fixed to a Gaussian of sigma
``--lp_psf_sigma`` when that is > 0, learnable otherwise), trained with
AdamW (betas 0.9/0.9), cosine warm restarts (T_0 15000, eta_min 1e-11),
``SSIMLabColorLoss`` and the metrics PSNR, SCC, SSIM, MAE, UIQ. Runs on the
GPU unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch.data import (
    AddAWGN,
    CircBlur,
    DataLoader,
    ImageDataset,
    RandCrop,
    Scale,
    gaussian_psf_np,
)
from torch_admm_deconv_tpu_torch.metrics import (
    MAELoss,
    PSNRMetric,
    SCCMetric,
    SSIMLabColorLoss,
    SSIMMetric,
    UIQMetric,
)
from torch_admm_deconv_tpu_torch.models.denoiser import (
    DivergentRestorer,
    flagship_divergent_restorer,
)
from torch_admm_deconv_tpu_torch.models.learned_prox import default_learned_prox
from torch_admm_deconv_tpu_torch.models.nafnet import NAFNet
from torch_admm_deconv_tpu_torch.train import (
    MetricsLogger,
    NNSaver,
    NNTrainer,
    cosine_annealing_warm_restarts,
    load_checkpoint,
    make_optimizer,
)


def learned_prox_psf(lp_kern: int, lp_psf_sigma: float):
    """The fixed PSF of ``--lp_kern``/``--lp_psf_sigma`` (a Gaussian when
    both are set), or None: a learnable PSF, or none at ``lp_kern`` 0."""
    return gaussian_psf_np(lp_kern, lp_psf_sigma) if lp_kern and lp_psf_sigma > 0 else None


def build_model(arch="flagship", model_cfg=None, nafnet_width=32, gradient_mode="unroll",
                lp_kern=0, lp_psf_sigma=0.0, *, device=None, generator=None):
    """The model ``--arch`` names, its weights drawn from ``generator``:
    the flagship (or the DivergentRestorer of the config's ``model``
    override), NAFNet [2, 2, 4, 8] / 12 / [2, 2, 2, 2] at ``nafnet_width``,
    or the learned-prox ADMM through ``default_learned_prox`` (JAX
    scripts/train.py:92-102)."""
    dev = resolve_device(device)
    if arch == "learned_prox":
        return default_learned_prox(kern=lp_kern, psf=learned_prox_psf(lp_kern, lp_psf_sigma),
                                    device=dev, generator=generator)
    if arch == "nafnet":
        return NAFNet(img_channel=3, width=nafnet_width, middle_blk_num=12,
                      enc_blk_nums=(2, 2, 4, 8), dec_blk_nums=(2, 2, 2, 2), device=dev,
                      generator=generator)
    if model_cfg:
        # architecture overrides from the config (the reference hardcodes
        # the model in its script)
        admm = {"kern_size": (), "max_iters": model_cfg.get("admm_iters", 100), "iso": True,
                "remat": True}
        filters = model_cfg.get("filters", 86)
        return DivergentRestorer(
            level_branches=model_cfg.get("level_branches", [2, 8, 32]), in_channels=3,
            final_channels=3, filters=filters, gate_channels=filters,
            attention_reduction=model_cfg.get("attention_reduction", 8),
            output_activation=torch.sigmoid, admms=[dict(admm), dict(admm)], device=dev,
            generator=generator)
    return flagship_divergent_restorer(gradient_mode=gradient_mode, device=dev,
                                       generator=generator)


def run_training(model, train_loader, eval_loader, lr, epochs, saver, *, skip_nonfinite=True,
                 light_train_metrics=False, accum_steps=1, init_params=None, resume_ckpt=None):
    """Train ``model`` as the script does: SSIMLabColorLoss, the metrics
    PSNR, SCC, SSIM, MAE and UIQ, AdamW at ``lr`` with warm restarts;
    returns the trainer."""
    lr_scheduler = cosine_annealing_warm_restarts(lr, t_0=15000, eta_min=1e-11)
    eval_metrics = [PSNRMetric(), SCCMetric(), SSIMMetric(), MAELoss(), UIQMetric()]
    loss_func = SSIMLabColorLoss()
    logger = MetricsLogger(loss_func, eval_metrics)
    trainer = NNTrainer(loss_func, eval_metrics, saver, logger,
                        skip_nonfinite_updates=skip_nonfinite,
                        light_train_metrics=light_train_metrics, accum_steps=accum_steps)
    trainer.run(model, make_optimizer(lr), epochs, train_loader, eval_loader,
                lr_scheduler=lr_scheduler, base_lr=lr, init_params=init_params,
                resume_ckpt=resume_ckpt)
    return trainer


def init_training(config_file, min_std, max_std, save_dir, model_name, device=None,
                  resume_ckpt=None, skip_nonfinite=True, lr_override=None, arch="flagship",
                  nafnet_width=32, light_train_metrics=False, accum_steps=1,
                  gradient_mode="unroll", lp_kern=0, lp_psf_sigma=0.0, blur_gaussian=0.0,
                  blur_ksize=9):
    """Build the data, model and trainer from the config and train; returns
    the trainer."""
    dev = resolve_device(device)
    with open(os.path.join(os.getcwd(), config_file)) as f:
        train_cfg = json.load(f)
    model = build_model(arch, train_cfg.get("model", {}), nafnet_width, gradient_mode, lp_kern,
                        lp_psf_sigma, device=dev, generator=torch.Generator().manual_seed(0))

    transforms = [RandCrop(tuple(train_cfg["im_shape"])), Scale()]
    if blur_gaussian > 0:
        # the non-blind deblur protocol: blur the degraded input circularly
        # with a fixed Gaussian PSF before the AWGN
        transforms.append(CircBlur(gaussian_psf_np(blur_ksize, blur_gaussian)))
    if max_std > 0:
        transforms.append(AddAWGN(std_range=(min_std, max_std), both=False))
    loaders = {}
    for phase in ("train", "eval"):
        cfg = train_cfg[phase]
        dset = ImageDataset(Path(cfg["x_path"]), Path(cfg["y_path"]), transforms=transforms)
        loaders[phase] = DataLoader(dset, batch_size=cfg["batch_size"], shuffle=True)

    init_params = None
    if train_cfg["train"].get("ckpt"):
        print("!!!!! LOADING CKPT !!!!!!!")
        init_params = load_checkpoint(train_cfg["train"]["ckpt"], map_location=dev)[
            "model_state_dict"]
    lr = lr_override if lr_override is not None else train_cfg["lr"]
    saver = NNSaver(os.path.join(os.getcwd(), save_dir), model_name)
    return run_training(model, loaders["train"], loaders["eval"], lr, train_cfg["epochs"], saver,
                        skip_nonfinite=skip_nonfinite, light_train_metrics=light_train_metrics,
                        accum_steps=accum_steps, init_params=init_params,
                        resume_ckpt=resume_ckpt)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Training script for image restoration")
    parser.add_argument("--config_file", "-c", type=str, default="configs/train_cfg.json",
                        help="Path to train config file")
    parser.add_argument("--min_awgn", "-m", type=int, default=0, help="Min std for AWGN")
    parser.add_argument("--max_awgn", "-M", type=int, default=0, help="Max std for AWGN")
    parser.add_argument("--save_dir", "-s", type=str, default="trained_models",
                        help="Dir (relative to cwd) to save models")
    parser.add_argument("--model_name", "-n", type=str, default="image_restorer",
                        help="Name of the training model")
    parser.add_argument("--device", "-d", type=str, default=None,
                        help="Training device: the GPU by default; 'cpu' only when named")
    parser.add_argument("--resume", type=str, default=None,
                        help="Checkpoint .tar to resume full state from")
    parser.add_argument("--skip_nonfinite", action=argparse.BooleanOptionalAction, default=True,
                        help="Apply no update for train steps whose loss or gradients are "
                             "non-finite (default on)")
    parser.add_argument("--lr", type=float, default=None,
                        help="Override the config learning rate")
    parser.add_argument("--arch", choices=["flagship", "nafnet", "learned_prox"],
                        default="flagship",
                        help="Model to train: the flagship DivergentRestorer, the NAFNet "
                             "comparison model or the learned-prox ADMM")
    parser.add_argument("--nafnet_width", type=int, default=32,
                        help="NAFNet width for --arch nafnet (the comparison checkpoint of "
                             "the eval harness is w64)")
    parser.add_argument("--light_train_metrics", action="store_true",
                        help="Compute only loss+MSE on train steps (eval keeps the full "
                             "metric set)")
    parser.add_argument("--accum_steps", type=int, default=1,
                        help="Gradient accumulation: average the gradients of N consecutive "
                             "batches per optimizer update")
    parser.add_argument("--gradient_mode", choices=["unroll", "implicit"], default="unroll",
                        help="flagship ADMM layers: 'unroll' backprops through all solver "
                             "iterations; 'implicit' uses the fixed-point adjoint")
    parser.add_argument("--lp_kern", type=int, default=0,
                        help="learned_prox PSF size (0 = denoising, H = I)")
    parser.add_argument("--lp_psf_sigma", type=float, default=0.0,
                        help="learned_prox: fix the PSF to a Gaussian of this sigma "
                             "(non-blind); 0 = learn it")
    parser.add_argument("--blur_gaussian", type=float, default=0.0,
                        help="Circularly blur train/eval inputs with a Gaussian PSF of this "
                             "sigma (deblur protocol); 0 = off")
    parser.add_argument("--blur_ksize", type=int, default=9,
                        help="PSF size for --blur_gaussian")
    args = parser.parse_args(argv)
    init_training(args.config_file, args.min_awgn, args.max_awgn, args.save_dir,
                  args.model_name, args.device, resume_ckpt=args.resume,
                  skip_nonfinite=args.skip_nonfinite, lr_override=args.lr, arch=args.arch,
                  nafnet_width=args.nafnet_width, light_train_metrics=args.light_train_metrics,
                  accum_steps=args.accum_steps, gradient_mode=args.gradient_mode,
                  lp_kern=args.lp_kern, lp_psf_sigma=args.lp_psf_sigma,
                  blur_gaussian=args.blur_gaussian, blur_ksize=args.blur_ksize)


if __name__ == "__main__":
    main()
