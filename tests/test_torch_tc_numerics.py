"""The tensor-core numerics of the whole-solve kernels K2 and K3, emulated
in torch on the CPU and held against the float32 plain versions.

On the card K2 and K3 compute their products on the tensor cores: in
'high' precision (and in 'mixed' outside the fast phase) as 3xTF32, each
operand split into hi = tf32(a) and lo = tf32(a - hi) (``cvt.rna.tf32.f32``)
and C = (hi lo' + lo hi') + hi hi' accumulated in float32; in the fast
phase of 'mixed' as one bf16 pass on operands rounded to bf16 with float32
accumulation. These tests run the same solves with those products and show
that they keep the card's gates with a tenth of their room: K2 x100 within
2e-5 of the float32 plain version ('high'; the card's bar is 2e-4), K3 at
tol 0 with equal iteration counts, and K3 at a real tol with counts within
1 and exit residuals at or below tol.
"""

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.kernels import vmem_solver as vs


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, ties away from zero
    (add half an ulp of tf32 to the magnitude bits, clear the low 13)."""
    i = v.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 product: the two small terms summed first."""
    ah, al = split(a)
    bh, bl = split(b)
    return (ah @ bl + al @ bh) + ah @ bh


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One bf16 pass: operands rounded to bf16 (nearest even), products
    exact in float32, float32 accumulation."""
    return vs._bf16(a) @ vs._bf16(b)


def _mm(fast: bool):
    return mm_bf16 if fast else mm_3xtf32


def tc_transform(v, mats, fast):
    """K2's transform (right stage first on the cas path) on the tensor
    cores."""
    if len(mats) == 4:
        return tc_xform(v, mats, fast)
    mm = _mm(fast)
    th, tw = mats
    return mm(th, mm(v, tw))


def tc_xform(v, mats, fast):
    """K3's and K4's transform (left stage first) on the tensor cores."""
    mm = _mm(fast)
    if len(mats) == 2:
        th, tw = mats
        return mm(mm(th, v), tw)
    th, thp, cw, sw = mats
    return mm(mm(th, v), cw) + mm(mm(thp, v), sw)


def _motion_psf():
    k = np.zeros((1, 1, 5, 5), np.float32)
    k[0, 0, 2, 1:5] = [0.4, 0.3, 0.2, 0.1]  # one-sided: the Hartley pair
    return torch.from_numpy(k)


# name: (shape, psf, iso, iso_mode); the motion PSF takes the Hartley pair
CASES = {
    "sample_cas": ((1, 3, 64, 64), None, True, "sample"),
    "aniso_cas": ((1, 3, 64, 64), None, False, "joint"),
    "joint_cas": ((1, 3, 64, 64), None, True, "joint"),
    "aniso_motion": ((2, 1, 48, 64), "motion", False, "joint"),
    "sample_motion": ((2, 1, 48, 64), "motion", True, "sample"),
}


def _input(rng, shape):
    return torch.from_numpy((rng.normal(size=shape) * 0.1 + 0.5).astype(np.float32))


def test_tf32_rounding_is_cvt_rna():
    one = 1.0
    ulp = 2.0**-10  # tf32 keeps 10 mantissa bits
    v = torch.tensor([one + ulp / 2, one + ulp / 4, -(one + ulp / 2), one + 3 * ulp / 2,
                      0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + 2 * ulp, 0.0],
                        dtype=torch.float32)
    got = tf32(v)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()


def test_3xtf32_split_keeps_float32_accuracy(rng):
    a = torch.from_numpy(rng.normal(size=(96, 80)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(80, 64)).astype(np.float32))
    hi, lo = split(a)
    # hi + lo carries a to 2^-21 of its magnitude
    assert float(((hi.double() + lo.double()) - a.double()).abs().max()) <= 2.0**-21 * float(a.abs().max())
    exact = a.double() @ b.double()
    scale = float((a.abs().double() @ b.abs().double()).max())
    err_3x = float((mm_3xtf32(a, b).double() - exact).abs().max()) / scale
    err_f32 = float(((a @ b).double() - exact).abs().max()) / scale
    err_1x = float(((tf32(a) @ tf32(b)).double() - exact).abs().max()) / scale
    assert err_3x <= 4 * max(err_f32, 2.0**-24)
    assert err_1x > 10 * err_3x  # one TF32 pass would not do


@pytest.mark.parametrize("case", sorted(CASES))
def test_k2_3xtf32_keeps_a_tenth_of_the_gate(rng, case):
    shape, psf, iso, iso_mode = CASES[case]
    kern = _motion_psf() if psf else None
    hty, freq, rho, tau, mats = vs.solve_inputs(_input(rng, shape), 0.05, 1.0, kern)
    mode = iso_mode if iso else None
    want = vs.admm_tv_vmem_plain(hty, freq, mats, rho, tau, mode, 100, 0)
    got = vs._fixed_plain(tc_transform, hty, freq, mats, rho, tau, mode, 100, 0)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("case", ["aniso_cas", "aniso_motion"])
def test_k2_mixed_on_the_tensor_cores_keeps_a_tenth_of_the_gate(rng, case):
    """'mixed': 75 bf16 passes then 25 3xTF32 iterations, against the
    plain version's bf16-rounded float32 products (card bar 2e-3)."""
    shape, psf, iso, iso_mode = CASES[case]
    kern = _motion_psf() if psf else None
    hty, freq, rho, tau, mats = vs.solve_inputs(_input(rng, shape), 0.05, 1.0, kern)
    fast = vs.fast_iterations("mixed", 0.75, 100)
    want = vs.admm_tv_vmem_plain(hty, freq, mats, rho, tau, None, 100, fast)
    got = vs._fixed_plain(tc_transform, hty, freq, mats, rho, tau, None, 100, fast)
    assert float((got - want).abs().max()) <= 2e-4


def _adaptive(rng, case, tol, maxit, precision, monkeypatch=None):
    shape, psf, iso, iso_mode = CASES[case]
    kern = _motion_psf() if psf else None
    xin = _input(rng, shape)
    cfg = vs.adaptive_config(shape, iso, iso_mode, maxit, tol, 10.0, 2.0, precision, None, False)
    inputs = vs.adaptive_inputs(xin, 0.05, 0.8, kern, cfg.g)
    hty, habs2, d2, lr, mats = inputs
    want = vs.admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lr, cfg)
    monkeypatch.setattr(vs, "_xform", tc_xform)
    got = vs.admm_tv_adaptive_vmem_plain(hty, habs2, d2, mats, lr, cfg)
    monkeypatch.undo()
    return got, want


@pytest.mark.parametrize("case", ["sample_cas", "aniso_motion"])
@pytest.mark.parametrize("precision", ["high", "mixed"])
def test_k3_tol0_counts_equal(rng, monkeypatch, case, precision):
    got, want = _adaptive(rng, case, 0.0, 60, precision, monkeypatch)
    assert torch.equal(got[5], want[5])
    assert int(got[5].min()) == 60
    x_tol = 2e-5 if precision == "high" else 2e-4
    assert float((got[0] - want[0]).abs().max()) <= x_tol
    # r, s and rho: the card's bar of 1e-3 relative, with a floor of 1e-7
    # for the dual residual, which falls to ~1e-6 in 60 iterations here
    for i in (6, 7, 8):
        assert torch.allclose(got[i], want[i], rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("case", ["sample_cas", "aniso_cas", "joint_cas", "aniso_motion"])
def test_k3_real_tol_counts_within_one(rng, monkeypatch, case):
    tol = 1e-4
    got, want = _adaptive(rng, case, tol, 500, "high", monkeypatch)
    iters, iters_p = got[5], want[5]
    assert int((iters - iters_p).abs().max()) <= 1
    assert int(iters.max()) < 500
    assert bool((got[6] <= tol).all()) and bool((got[7] <= tol).all())
