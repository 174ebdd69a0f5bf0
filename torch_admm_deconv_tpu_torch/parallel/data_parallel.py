"""Data parallelism: independent ADMM instances and model replicas per rank.

Counterpart of torch_admm_deconv_tpu/parallel/data_parallel.py. The batch is
split by rows over the ``data`` axis, one block per rank. The solver's
instances are independent per image except in the iso 'compat' mode, whose
norm over (B, C) spans the global batch: JAX gets that sum from the psum
XLA inserts; here ``admm_tv(psum_axis=...)`` all-reduces it. Training wraps
the model in ``DistributedDataParallel``, which averages the gradients of
the ranks' local mean losses: the gradient of the global mean loss.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from torch_admm_deconv_tpu_torch._dist import resolve_group, size_rank
from torch_admm_deconv_tpu_torch.models.regularizers import (
    clip_grads_by_value,
    train_weight_clipper,
)
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv
from torch_admm_deconv_tpu_torch.parallel.mesh import local_block


def shard_batch(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This rank's rows of the full NCHW batch ``x`` (JAX
    data_parallel.py:26-28 places the whole batch sharded)."""
    return local_block(torch.as_tensor(x), 0, mesh, axis)


def data_parallel_solve(
    xin,
    lmbd,
    rho,
    kern=None,
    mesh=None,
    axis: str = "data",
    **solver_kwargs,
):
    """Batch-split classical TV-ADMM solve (JAX data_parallel.py:31-53).

    ``xin`` is this rank's rows of the batch and the result its rows of the
    restored batch. Each rank solves its images; the iso 'compat' norm sums
    over the ranks of ``axis`` every iteration, so the result is the
    single-process solve of the global batch. ``mesh=None`` is plain
    :func:`admm_tv`."""
    if mesh is None:
        return admm_tv(xin, lmbd, rho, kern, **solver_kwargs)
    return admm_tv(xin, lmbd, rho, kern, psum_axis=resolve_group(mesh, axis), **solver_kwargs)


def make_dp_train_step(
    model: nn.Module,
    opt,
    loss_fn: Callable,
    mesh,
    axis: str = "data",
    clip_value: float = 1.0,
    clamp_admm_params: bool = True,
):
    """A data-parallel train step (JAX data_parallel.py:56-94).

    ``model`` is wrapped in ``DistributedDataParallel`` over the group of
    ``axis`` (the world for ``mesh=None``; DDP also broadcasts rank 0's
    weights to every rank); ``opt`` is a torch optimizer over its
    parameters, or a function of the parameters that makes one
    (``train.make_optimizer(lr)``). The returned
    ``step(x, y, lr)`` takes this rank's rows of the batch and, in the JAX
    order: (1) the gradient of the global-mean loss (``loss_fn(model(x),
    y)`` is this rank's mean; DDP averages the gradients over the ranks);
    (2) clips each gradient to ``clip_value``; (3) steps the optimizer at
    ``lr``; (4) clamps lambda and rho (``models.regularizers``). It returns
    the global-mean loss as a Python float. ``step.module`` is the DDP
    wrapper and ``step.optimizer`` the optimizer."""
    from torch.nn.parallel import DistributedDataParallel

    group = resolve_group(mesh, axis) if mesh is not None else dist.group.WORLD
    n, _ = size_rank(group)
    param = next(model.parameters())
    device_ids = [param.device.index] if param.device.type == "cuda" else None
    ddp = DistributedDataParallel(model, device_ids=device_ids, process_group=group)
    optimizer = opt if isinstance(opt, torch.optim.Optimizer) else opt(model.parameters())
    params = [p for p in model.parameters() if p.requires_grad]
    # every parameter takes part in every update, as under optax and in the
    # port's NNTrainer
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)

    def step(x: torch.Tensor, y: torch.Tensor, lr: Optional[float] = None) -> float:
        optimizer.zero_grad(set_to_none=False)
        loss = loss_fn(ddp(x), y)
        loss.backward()
        clip_grads_by_value(params, clip_value)
        if lr is not None:
            for pg in optimizer.param_groups:
                pg["lr"] = lr
        optimizer.step()
        if clamp_admm_params:
            train_weight_clipper(model)
        total = loss.detach().clone()
        dist.all_reduce(total, group=group)
        return float(total) / n

    step.module = ddp
    step.optimizer = optimizer
    return step
