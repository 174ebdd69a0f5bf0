"""Operations and bytes of a fixed-iteration TV-ADMM solve, fixed by the
solve's shapes and iteration count, whatever algorithm or schedule a
kernel uses to compute it.

The work is what the function needs, counted on the FFT basis: each
iteration takes two transforms of every plane (the x-update's forward and
inverse transform), each a real 2-D FFT of the (h, w) plane, counted as
half the conventional 5 n log2 n flops of a complex FFT of n = h w points;
the scaling of the half spectrum by the real diagonal (2 flops a complex
bin); and the elementwise chain: differences, shrinkage, dual update and
adjoint sum, 25 flops a pixel. A kernel that computes the transforms by
dense products (K2's cas transform, 2 h w (h + w) flops each) does more
operations than these, and is not credited for them. Bytes: the
right-hand side read and the answer written once, and the real half
spectrum of the diagonal read once.

The least time counts every flop at the float32 peak (an FFT's
butterflies and the chain run there at float32 accuracy), against the
bytes at the HBM peak.
"""

from __future__ import annotations

import math

CHAIN_FLOPS_PER_PIXEL = 25


def transform_flops(h: int, w: int) -> float:
    """Flops of one real 2-D FFT of one (h, w) plane."""
    n = h * w
    return 2.5 * n * math.log2(n)


def fixed_solve(planes: int, h: int, w: int, maxit: int) -> dict:
    """{'fft_flops', 'chain_flops', 'bytes'} of one fixed-iteration solve
    of ``planes`` (h, w) planes."""
    bins = h * (w // 2 + 1)
    return {
        "fft_flops": planes * maxit * 2 * transform_flops(h, w),
        "chain_flops": planes * maxit * (CHAIN_FLOPS_PER_PIXEL * h * w + 2 * bins),
        "bytes": 4 * (2 * planes * h * w + bins),
    }


def flops(work: dict) -> float:
    return work["fft_flops"] + work["chain_flops"]


def add(*works: dict) -> dict:
    return {k: sum(wk[k] for wk in works) for k in works[0]}


def least_seconds(work: dict, peaks: dict) -> float:
    """The least time the card could take for ``work``."""
    return max(flops(work) / peaks["f32_flops"], work["bytes"] / peaks["hbm_bytes_per_s"])
