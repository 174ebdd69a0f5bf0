"""Flax parameter trees -> the port's state dicts.

The port's modules carry the JAX package's module names, so a parameter's
path is the same on both sides; only the leaf names and some layouts differ:

* ``Conv2d`` kernels are OIHW on both sides, and ``Conv1d`` kernels
  (``local_patch.py``) OIH: ``kernel`` -> ``weight``;
* a ``ConvTranspose2d`` kernel (``up_conv`` of the up blocks and
  ``conv2d_b_1`` of ``PatchProcessor``) is stored (out, in, kh, kw) and
  flipped at apply time in JAX (layers_common.py:117-131); torch's (in,
  out, kh, kw) is its transpose in the first two axes, with no flip;
* a ``Linear`` kernel is (in, out); torch wants (out, in);
* ``InstanceNorm2d`` ``scale`` -> ``weight``.

Everything else keeps its name and layout: ``LayerNorm2d``'s
``weight``/``bias``, NAFNet's (1, c, 1, 1) ``beta`` and ``gamma`` and its
``up_*`` layers (1x1 ``Conv2d`` kernels without bias, not transposed
convs), the (1,) ``lmbda``/``rho``/``b`` and the (1, 1, kh, kw) PSF ``w``
of the ADMM layers and of ``LearnedProxADMM``. The trees checked against
the JAX package (tests/test_torch_*.py): ADMMDeconv, CBAM,
ChannelWiseAttention, DivergentRestorer, NAFNet, DepthwiseDownBlock,
MultiScaleConvPool, ParallelUpsampleReduce, LocalAttentionPatch,
Autoencoder, UpDownScale, Restorer, Deconvs, ADMMFusion, RestorerV2 and
LearnedProxADMM.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

CONV_TRANSPOSE_NAMES = frozenset({"up_conv", "conv2d_b_1"})


def _walk(tree: Mapping, prefix=()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), value


def flax_to_torch(params: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """Convert a Flax parameter tree (``{'params': ...}`` or its inner dict,
    leaves as numpy arrays) into a state dict for the port's module."""
    if set(params) == {"params"}:
        params = params["params"]
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, value in _walk(params):
        arr = np.array(value, dtype=np.float32)
        *parents, leaf = path
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif parents and parents[-1] in CONV_TRANSPOSE_NAMES:
                arr = arr.transpose(1, 0, 2, 3)
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([*parents, leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
