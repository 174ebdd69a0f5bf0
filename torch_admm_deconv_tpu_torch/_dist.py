"""Process groups and the sums across them, shared by the solver and
``parallel/``.

A reduction "over an axis" in the JAX package is a ``lax.psum`` inside a
sharded program. Here it is an ``all_reduce`` over a process group, named by
a ``torch.distributed`` ``ProcessGroup``, a ``DeviceMesh`` and the name of
one of its dimensions, or a one-dimensional ``DeviceMesh``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def resolve_group(spec, axis: Optional[str] = None):
    """The process group ``spec`` names: a ``ProcessGroup`` as it is, a
    ``(mesh, axis)`` pair or a mesh with ``axis`` as that dimension's group,
    a one-dimensional mesh as its only group. ``None`` stays ``None``."""
    if spec is None:
        return None
    if isinstance(spec, str):
        raise ValueError(f"{spec!r} names a mesh axis: pass (mesh, {spec!r}) or a ProcessGroup")
    if isinstance(spec, tuple):
        spec, axis = spec
    if hasattr(spec, "get_group"):  # a DeviceMesh
        return spec.get_group(axis)
    return spec


def size_rank(group) -> Tuple[int, int]:
    """(size, this process's rank) of ``group``; (1, 0) for ``None``."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward, and the sum of the incoming
    gradients in the backward: d(sum_r L_r)/dx_j reaches rank j from every
    rank's loss. (``torch.distributed.nn.functional.all_reduce`` computes
    the same, and is deprecated from torch 2.13.)"""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` into a new tensor (``x`` itself for
    ``None``), differentiable when autograd records ``x``."""
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, group)
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out
