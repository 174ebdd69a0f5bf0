"""K4's tensor-core numerics (the clustered interleaved solve,
``csrc/vmem_interleaved.cu``), emulated in torch on the CPU.

The emulation computes the left-first transform with 3xTF32 products, T_h' v
read as the rows of T_h v permuted k -> (H - k) % H, and the Hartley pair's
two right products summed in one accumulator, as the kernel computes them.
Each CTA sums a product over the depth in chunks of 32, starting at a chunk
of its own (so that CTAs do not ask for the same lines at once): the
emulation sums its chunks in that rotated order, the hi products in float32
apart from the small terms. The CUDA kernel runs only on the card
(chip_smoke.py holds it against its plain version there).

These cases live apart from tests/test_torch_k4_k1.py so that a second
test worker takes them: they are the slowest of the port's CPU tests.
"""

import pytest
import torch

from tests.test_torch_k4_k1 import _motion_psf, _noisy
from tests.test_torch_tc_numerics import mm_bf16, split
from torch_admm_deconv_tpu_torch.kernels import vmem_solver as t_vmem

CHUNK = 32  # the kernel's depth step


def mm_chunks(terms, fast, rot):
    """sum_i a_i @ b_i as K4 accumulates it: depth chunks of CHUNK taken from
    chunk ``rot`` on (each term in turn), 3xTF32 with the small terms and the
    hi products in separate float32 sums, or one bf16 pass."""
    small = hi = 0.0
    for a, b in terms:
        k = a.shape[-1]
        n = -(-k // CHUNK)
        for c in ((i + rot) % n for i in range(n)):
            sl = slice(c * CHUNK, (c + 1) * CHUNK)
            if fast:
                hi = hi + mm_bf16(a[..., sl], b[..., sl, :])
                continue
            ah, al = split(a[..., sl])
            bh, bl = split(b[..., sl, :])
            small = small + (ah @ bl + al @ bh)
            hi = hi + ah @ bh
    return small + hi


def k4_xform(v, mats, fast, rot=0):
    """K4's T(v) on the tensor cores: left stage first; on the Hartley path
    T_h' v as the permuted rows of T_h v, and both right products in one
    accumulator."""
    th = mats[0]
    d = mm_chunks([(th, v)], fast, rot)
    if len(mats) == 2:
        return mm_chunks([(d, mats[1])], fast, rot)
    h = d.shape[-2]
    a = d[..., [(h - k) % h for k in range(h)], :]
    return mm_chunks([(d, mats[2]), (a, mats[3])], fast, rot)


K4_EMU = {
    # name: (shape, psf, iso)
    "aniso_cas": ((1, 3, 48, 64), None, False),
    "joint_cas": ((1, 3, 48, 64), None, True),
    "aniso_pair": ((2, 1, 40, 56), "motion", False),
    "joint_pair": ((2, 1, 40, 56), "motion", True),
}


@pytest.mark.parametrize("case", sorted(K4_EMU))
@pytest.mark.parametrize("rot", [0, 1])
def test_k4_3xtf32_keeps_a_tenth_of_the_gate(rng, case, rot):
    shape, psf, iso = K4_EMU[case]
    kern = None if psf is None else torch.from_numpy(_motion_psf())
    hty, freq, rho, tau, mats = t_vmem.solve_inputs(torch.from_numpy(_noisy(rng, shape)), 0.05,
                                                    1.0, kern)
    mode = "joint" if iso else None
    want = t_vmem.admm_tv_vmem_interleaved_plain(hty, freq, mats, rho, tau, mode, 100, 0)
    xform = lambda v, m, fast: k4_xform(v, m, fast, rot)  # noqa: E731
    got = t_vmem._fixed_plain(xform, hty, freq, mats, rho, tau, mode, 100, 0)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5  # the card's gate: 2e-4


# 'mixed' (card bar 2e-3): the cas path keeps a tenth of it; on the Hartley
# path the two bf16 right products summed chunk by chunk in one accumulator
# round otherwise than the plain version's two float32 products, and a
# one-ulp bf16 flip of the next operand survives the exact tail (5.6e-4
# here): half the bar
@pytest.mark.parametrize("case,tol", [("aniso_cas", 2e-4), ("aniso_pair", 1e-3)])
def test_k4_mixed_on_the_tensor_cores_keeps_the_gate(rng, case, tol):
    """'mixed': 75 bf16 passes, then 25 3xTF32 iterations."""
    shape, psf, iso = K4_EMU[case]
    kern = None if psf is None else torch.from_numpy(_motion_psf())
    hty, freq, rho, tau, mats = t_vmem.solve_inputs(torch.from_numpy(_noisy(rng, shape)), 0.05,
                                                    1.0, kern)
    fast = t_vmem.fast_iterations("mixed", 0.75, 100)
    want = t_vmem.admm_tv_vmem_interleaved_plain(hty, freq, mats, rho, tau, None, 100, fast)
    got = t_vmem._fixed_plain(k4_xform, hty, freq, mats, rho, tau, None, 100, fast)
    assert float((got - want).abs().max()) <= tol
