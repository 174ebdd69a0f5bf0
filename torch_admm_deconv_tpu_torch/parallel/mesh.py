"""Process-group setup and the split of arrays over the ranks.

Counterpart of torch_admm_deconv_tpu/parallel/mesh.py. JAX runs one program
over a mesh of devices and lays a global array out over it; PyTorch runs one
process per GPU, joined by ``torch.distributed``, and each process holds its
own block. So:

- ``init_distributed`` starts the process group: NCCL when the device is
  CUDA, gloo only when the caller names the CPU.
- ``make_mesh`` is a ``DeviceMesh`` from ``init_device_mesh``: a 1-D
  ``data`` mesh over the world by default, or e.g. a 2-D ``(data, space)``
  one. An axis's ``ProcessGroup`` is ``mesh.get_group(axis)``, and a rank's
  place along it that group's rank.
- There are no sharding objects: ``batch_sharding``, ``spatial_sharding``
  and ``replicated`` return the function that cuts this rank's block out of
  a full array (batch rows, image rows, everything), and ``gather`` puts
  the blocks of an axis back together. ``shard_host_batch`` is the
  identity on this process's rows: the rank already holds them.
"""

from __future__ import annotations

import datetime
import os
from functools import partial
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from torch_admm_deconv_tpu_torch._device import resolve_device
from torch_admm_deconv_tpu_torch._dist import resolve_group, size_rank


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    timeout_s: float = 600.0,
) -> Tuple[int, int]:
    """Join the process group (JAX mesh.py:39-66) and return ``(rank,
    world)``.

    Without arguments the group comes from the environment that
    ``torch.distributed.run`` sets (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). ``coordinator_address``
    (``host:port`` or ``tcp://host:port``) with ``num_processes`` and
    ``process_id`` names it explicitly. ``device``: ``None`` means CUDA,
    where the backend is NCCL and the process takes the GPU ``LOCAL_RANK``
    (else ``rank % device_count``); ``"cpu"`` means gloo. A collective that
    waits longer than ``timeout_s`` fails. A process already in a group
    gets its rank and size back."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    dev = resolve_device(device)
    kwargs = {}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        addr = coordinator_address
        kwargs = dict(init_method=addr if "://" in addr else f"tcp://{addr}",
                      world_size=int(num_processes), rank=int(process_id))
    if dev.type == "cuda":
        rank = int(process_id) if process_id is not None else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(axis_sizes: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",)):
    """A ``DeviceMesh`` over every rank (JAX mesh.py:19-36): ``make_mesh()``
    is the 1-D ``data`` mesh, ``make_mesh((2, 2), ("data", "space"))`` a
    2-D one. The sizes must multiply to the world size: each rank drives
    one device."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = (world,)
    n = int(np.prod(axis_sizes))
    if n > world:
        raise ValueError(f"mesh needs {n} devices, have {world}")
    if n < world:
        raise ValueError(f"mesh covers {n} of the {world} ranks; each rank drives one device")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def process_batch_bounds(global_batch: int) -> slice:
    """This process's rows of the global batch (JAX mesh.py:69-80)."""
    n, i = size_rank(dist.group.WORLD if dist.is_initialized() else None)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide over {n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shard_host_batch(local_batch, mesh=None) -> torch.Tensor:
    """This process's rows as a tensor on its device, the mesh's device type
    (CUDA without a mesh); JAX mesh.py:83-93 assembles a global array from
    them, here each rank keeps its own."""
    dev = resolve_device(None if mesh is None else mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return torch.as_tensor(np.asarray(local_batch), device=dev)


def local_block(x: torch.Tensor, dim: int, mesh=None, axis: str = "data") -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over the mesh axis
    ``axis`` (the whole of ``x`` on one rank). The size must divide."""
    n, i = size_rank(resolve_group(mesh, axis))
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"size {size} of dim {dim} must divide over {n} shards of {axis!r}")
    per = size // n
    return x.narrow(dim, i * per, per)


def gather(x_local: torch.Tensor, dim: int, mesh=None, axis: str = "data") -> torch.Tensor:
    """The blocks of every rank of ``axis`` joined along ``dim`` in rank
    order, on every rank: the inverse of :func:`local_block`."""
    group = resolve_group(mesh, axis)
    n, _ = size_rank(group)
    if n == 1:
        return x_local
    x_local = x_local.contiguous()
    parts = [torch.empty_like(x_local) for _ in range(n)]
    dist.all_gather(parts, x_local, group=group)
    return torch.cat(parts, dim=dim)


def batch_sharding(mesh, axis: str = "data"):
    """NCHW batch split over its batch rows (JAX mesh.py:96-98): the
    function that returns this rank's rows of a full batch."""
    return partial(local_block, dim=0, mesh=mesh, axis=axis)


def spatial_sharding(mesh, axis: str = "space"):
    """NCHW batch split over its image rows H (JAX mesh.py:101-103): the
    function that returns this rank's rows of a full image batch."""
    return partial(local_block, dim=-2, mesh=mesh, axis=axis)


def replicated(mesh):
    """Every rank holds all of it (JAX mesh.py:106-107): the identity."""
    return lambda x: x
