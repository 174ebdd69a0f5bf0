"""Training harness: the update step, epoch loops and metric logging.

Counterpart of torch_admm_deconv_tpu/train/trainer.py (:39-454). A train
step runs forward, loss and backward, clips the gradients by value
(``clip_grad_value_(1)``), steps AdamW and clamps lmbda/rho; a batch crosses
from the host to the device once per step. Kept from the reference and the
JAX trainer:

* requesting PSNR auto-registers MSE;
* the LR scheduler steps once per EVAL batch (a reference quirk;
  ``scheduler_step_per='train_step'`` for the sane version);
* epoch end saves through ``NNSaver`` keyed on the eval loss and dumps the
  metric CSV;
* a parameter table prints at start.

The per-metric sums and finite counts of an epoch stay on the device and
are read on the host once per epoch (``_flush_acc``). The only per-step host
read is the skip decision of ``skip_nonfinite_updates`` (and of
``accum_steps > 1``, which always skips an update with no finite
micro-gradient).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from torch_admm_deconv_tpu_torch.metrics.losses import MSE, Metric
from torch_admm_deconv_tpu_torch.models.regularizers import (
    clip_grads_by_value,
    train_weight_clipper,
)
from torch_admm_deconv_tpu_torch.train.logger import MetricsLogger
from torch_admm_deconv_tpu_torch.train.saver import NNSaver, load_checkpoint


def make_optimizer(lr: float, betas=(0.9, 0.9), weight_decay: float = 0.01):
    """AdamW with the reference's betas, as a function of the parameters
    (the trainer calls it with the model's). The trainer sets each step's
    LR in the optimizer's param groups."""
    return functools.partial(torch.optim.AdamW, lr=lr, betas=tuple(betas), eps=1e-8,
                             weight_decay=weight_decay)


def _all_finite(tensors) -> torch.Tensor:
    """One device bool: every element of every tensor is finite."""
    return torch.isfinite(torch.cat([t.reshape(-1) for t in tensors])).all()


class NNTrainer:
    def __init__(
        self,
        loss: Metric,
        metrics: Sequence[Metric],
        saver: Optional[NNSaver],
        logger: Optional[MetricsLogger] = None,
        clip_value: float = 1.0,
        clamp_admm_params: bool = True,
        scheduler_step_per: str = "eval_batch",
        on_nonfinite: str = "warn",
        skip_nonfinite_updates: bool = False,
        light_train_metrics: bool = False,
        accum_steps: int = 1,
    ):
        if scheduler_step_per not in ("eval_batch", "train_step"):
            raise ValueError(f"scheduler_step_per: {scheduler_step_per!r}")
        if on_nonfinite not in ("warn", "raise"):
            raise ValueError(f"on_nonfinite: {on_nonfinite!r}")
        if accum_steps < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        self.loss = loss
        self.saver = saver
        self.logger = logger
        self.clip_value = clip_value
        self.clamp_admm_params = clamp_admm_params
        self.scheduler_step_per = scheduler_step_per
        self.on_nonfinite = on_nonfinite
        # a train step whose loss or (clipped) gradients are non-finite
        # applies no update: parameters and optimizer state keep their values,
        # so one exploding step cannot NaN-poison the run
        self.skip_nonfinite_updates = skip_nonfinite_updates
        # train steps compute only the loss and MSE (for the PSNR from the
        # epoch-mean MSE); SSIM/UIQ/SCC run on eval steps only, and their
        # train columns are NaN
        self.light_train_metrics = light_train_metrics
        # each update averages the finite gradients of ``accum_steps``
        # consecutive loader batches, at the peak memory of one; the
        # micro-batches do not couple through the 'compat' shrinkage
        self.accum_steps = int(accum_steps)
        names = [m.m_name for m in metrics]
        self.metrics = list(metrics)
        if "psnr" in names and "mse" not in names:
            self.metrics.append(MSE(metrics[0].device))
        self._sched_count = 0
        self.skipped_updates = 0
        self.model: Optional[nn.Module] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None

    # ------------------------------------------------------------------
    def _phase_metrics(self, phase: str):
        if phase == "train" and self.light_train_metrics:
            return [m for m in self.metrics if m.m_name == "mse"]
        return self.metrics

    def _fresh_acc(self, phase: str = "eval") -> dict:
        names = [self.loss.m_name] + [m.m_name for m in self._phase_metrics(phase)]
        dev = self._device
        return {
            "sums": {n: torch.zeros((), dtype=torch.float32, device=dev) for n in names},
            "finite_counts": {n: torch.zeros((), dtype=torch.int32, device=dev) for n in names},
            "count": 0,
            "nonfinite_steps": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def _accumulate(self, acc: dict, lv, out, y, phase: str) -> None:
        """Fold one step's loss and metrics into the device sums; a
        non-finite value is counted, not summed."""
        with torch.no_grad():
            stats = {m.m_name: m(out, y) for m in self._phase_metrics(phase)}
            stats[self.loss.m_name] = lv
            for name, v in stats.items():
                finite = torch.isfinite(v)
                acc["sums"][name] += torch.where(finite, v, 0.0).to(torch.float32)
                acc["finite_counts"][name] += finite
            acc["count"] += 1
            acc["nonfinite_steps"] += ~torch.isfinite(lv)

    def _flush_acc(self, acc: dict, phase: str) -> int:
        """One host read per epoch: fold the device sums into the logger."""
        names = list(acc["sums"])
        host = torch.stack(
            [acc["sums"][n].double() for n in names]
            + [acc["finite_counts"][n].double() for n in names]
            + [acc["nonfinite_steps"].double()]
        ).tolist()
        sums, counts = host[: len(names)], host[len(names): 2 * len(names)]
        n_bad = int(host[-1])
        if n_bad:
            print(f"WARNING: {n_bad}/{acc['count']} {phase} steps had a non-finite loss; "
                  "they are excluded from the epoch averages.", flush=True)
            if self.on_nonfinite == "raise":
                raise FloatingPointError(
                    f"{n_bad} non-finite {phase} losses in epoch (on_nonfinite='raise')")
        if self.logger:
            self.logger.push_step_sums(dict(zip(names, sums)),
                                       {n: int(c) for n, c in zip(names, counts)})
        return n_bad

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self._device.type == "cuda":
            return t.pin_memory().to(self._device, non_blocking=True)
        return t.to(self._device)

    # ------------------------------------------------------------------
    def _apply_update(self, lr: float, apply) -> None:
        """Unless ``apply`` is a false device bool (read here, the one host
        read of a step), set the LR, step the optimizer and clamp."""
        if apply is not None and not bool(apply):
            self.skipped_updates += 1
            return
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        if self.clamp_admm_params:
            train_weight_clipper(self.model)

    def _train_step(self, x, y, lr: float, acc: dict) -> None:
        self.optimizer.zero_grad(set_to_none=False)
        out = self.model(x)
        lv = self.loss(out, y)
        lv.backward()
        clip_grads_by_value(self._params, self.clip_value)
        apply = None
        if self.skip_nonfinite_updates:
            apply = torch.isfinite(lv) & _all_finite([p.grad for p in self._params])
        self._apply_update(lr, apply)
        self._accumulate(acc, lv.detach(), out.detach(), y, "train")

    def _train_step_accum(self, xs, ys, lr: float, acc: dict) -> None:
        """One update from the mean of the finite micro-gradients of the
        ``accum_steps`` micro-batches in ``xs``/``ys``; no update when none
        is finite."""
        params = self._params
        gsum = [torch.zeros_like(p) for p in params]
        n_ok = torch.zeros((), dtype=torch.float32, device=self._device)
        for x, y in zip(xs, ys):
            self.optimizer.zero_grad(set_to_none=False)
            out = self.model(x)
            lv = self.loss(out, y)
            lv.backward()
            ok = torch.isfinite(lv) & _all_finite([p.grad for p in params])
            with torch.no_grad():
                for s, p in zip(gsum, params):
                    s += torch.where(ok, p.grad, 0.0)
                n_ok += ok
            self._accumulate(acc, lv.detach(), out.detach(), y, "train")
        with torch.no_grad():
            scale = 1.0 / torch.clamp_min(n_ok, 1.0)
            for s, p in zip(gsum, params):
                p.grad.copy_(s * scale)
        clip_grads_by_value(params, self.clip_value)
        self._apply_update(lr, n_ok > 0)

    def _eval_step(self, x, y, acc: dict) -> None:
        with torch.no_grad():
            out = self.model(x)
            lv = self.loss(out, y)
        self._accumulate(acc, lv, out, y, "eval")

    # ------------------------------------------------------------------
    def _setup(self, model: nn.Module, optimizer, base_lr: float, init_params=None,
               resume_ckpt=None) -> int:
        """Bind the model, build its optimizer, restore a checkpoint; returns
        the first epoch to run."""
        self.model = model
        self._device = next(model.parameters()).device
        if init_params is not None:
            model.load_state_dict(init_params)
        self._params = list(model.parameters())
        # every parameter takes part in every update, as under optax: one
        # whose output the loss does not use still gets AdamW's decay
        for p in self._params:
            p.grad = torch.zeros_like(p)
        make = optimizer if optimizer is not None else make_optimizer(base_lr)
        self.optimizer = make(self._params)
        self._base_lr = base_lr
        if resume_ckpt is None:
            return 0
        # full-state resume: the reference restores model weights only
        ckpt = load_checkpoint(resume_ckpt, map_location=self._device)
        model.load_state_dict(ckpt["model_state_dict"])
        self.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        return int(ckpt["epoch"]) + 1

    def run(
        self,
        model: nn.Module,
        optimizer: Optional[Callable] = None,
        epochs: int = 1,
        train_dataloader=None,
        eval_dataloader=None,
        lr_scheduler: Optional[Callable[[int], float]] = None,
        base_lr: float = 8.8e-4,
        init_params: Optional[dict] = None,
        resume_ckpt: Optional[str] = None,
    ) -> nn.Module:
        """Train ``model`` in place. ``optimizer`` is a function of the
        parameters (``make_optimizer(lr)``; ``None`` means
        ``make_optimizer(base_lr)``); ``init_params`` a state dict to start
        from; ``resume_ckpt`` a checkpoint of ``NNSaver`` whose model,
        optimizer state and epoch it restores."""
        start_epoch = self._setup(model, optimizer, base_lr, init_params, resume_ckpt)
        self.get_model_params(model)
        for epoch in range(start_epoch, epochs):
            print(f"\n/////////// [ EPOCH: {epoch} ] ///////////")
            self.train(train_dataloader, lr_scheduler)
            if eval_dataloader is not None:
                self.eval(eval_dataloader, lr_scheduler)
                epoch_loss = self.get_epoch_metrics("eval")[self.loss.m_name]
            else:
                epoch_loss = self.get_epoch_metrics("train")[self.loss.m_name]
            self.on_epoch_end(epoch, epoch_loss)
        return model

    def _current_lr(self, lr_scheduler) -> float:
        if lr_scheduler is None:
            return self._base_lr
        return float(lr_scheduler(self._sched_count))

    def train(self, train_dataloader, lr_scheduler=None) -> None:
        if self.logger:
            self.logger.reinit_step_stats()
        print("\n [ TRAINING ]")
        acc = self._fresh_acc("train")
        group_x, group_y = [], []
        for x, y in train_dataloader:
            group_x.append(np.asarray(x))
            group_y.append(np.asarray(y))
            if len(group_x) < self.accum_steps:
                continue
            lr = self._current_lr(lr_scheduler)
            if self.accum_steps > 1:
                self._train_step_accum(self._to_device(np.stack(group_x)),
                                       self._to_device(np.stack(group_y)), lr, acc)
            else:
                self._train_step(self._to_device(group_x[0]), self._to_device(group_y[0]),
                                 lr, acc)
            group_x, group_y = [], []
            if self.scheduler_step_per == "train_step":
                self._sched_count += 1
        if group_x:
            # a trailing partial group is less than one update's worth of data
            print(f"(dropped {len(group_x)} trailing batches < accum_steps="
                  f"{self.accum_steps})", flush=True)
        self._flush_acc(acc, "train")
        if self.logger:
            self.logger("train")
            self._print_epoch_metrics("train")

    def eval(self, eval_dataloader, lr_scheduler=None) -> None:
        if self.logger:
            self.logger.reinit_step_stats()
        print("\n [ EVALUATING ]")
        acc = self._fresh_acc("eval")
        for x, y in eval_dataloader:
            self._eval_step(self._to_device(np.asarray(x)), self._to_device(np.asarray(y)), acc)
            if self.scheduler_step_per == "eval_batch":
                # reference quirk: scheduler.step() per eval batch
                self._sched_count += 1
        self._flush_acc(acc, "eval")
        if self.logger:
            self.logger("eval")
            self._print_epoch_metrics("eval")

    def _print_epoch_metrics(self, phase: str) -> None:
        msg = " ".join(f"{phase}_{k}: {v:.4f};" for k, v in self.get_epoch_metrics(phase).items())
        print("\n" + msg)

    def get_epoch_metrics(self, phase: str) -> Dict[str, float]:
        return self.logger.get_avg_metrics(phase) if self.logger else {}

    @staticmethod
    def get_model_params(model: nn.Module) -> int:
        total = 0
        print(f"{'Modules':60s} | Parameters")
        for name, p in model.named_parameters():
            print(f"{name:60s} | {p.numel()}")
            total += p.numel()
        print(f"Total Trainable Params: {total}")
        return total

    def on_epoch_end(self, epoch: int, loss_val: float) -> None:
        if self.saver is None:
            return
        logs = self.logger.get_logged(reformat=True) if self.logger else None
        self.saver.save_on_epoch_end(epoch, self.model.state_dict(),
                                     self.optimizer.state_dict(), loss_val, logs)
