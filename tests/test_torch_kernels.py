"""The port's kernels (K1 fused step, K2 whole solve) held against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper runs its kernel's plain version, so these tests hold
the plain versions (and the wrappers' argument handling) to the TPU kernels'
semantics; the CUDA kernels themselves are held against the plain versions
on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.kernels import fused_admm as t_fused
from torch_admm_deconv_tpu_torch.kernels import vmem_solver as t_vmem
from torch_admm_deconv_tpu_torch.ops import solver as t_solver

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu.kernels.fused_admm import fused_elementwise_step  # noqa: E402
from torch_admm_deconv_tpu.kernels.vmem_solver import admm_tv_vmem  # noqa: E402
from tests.oracles import numpy_admm as oracle  # noqa: E402

SHAPE = (2, 3, 16, 128)


def _planes(rng, n, shape=SHAPE):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _noisy(rng, shape=SHAPE):
    return (rng.normal(size=shape) * 0.1 + 0.5).astype(np.float32)


def _motion_psf():
    k = np.zeros((1, 1, 5, 5), np.float32)
    k[0, 0, 2, 1:5] = [0.4, 0.3, 0.2, 0.1]  # one-sided: asymmetric
    return k


# K1: the TPU test's tolerances (tests/test_fused_kernel.py:33-35), float32
# rounding of the same chain in a different association
@pytest.mark.parametrize("iso,iso_mode", [(False, "compat"), (True, "sample"), (True, "joint")])
@pytest.mark.parametrize("tau", [0.15, -0.1])
def test_fused_step_matches_jax(rng, iso, iso_mode, tau):
    x, ux, uy, hty = _planes(rng, 4)
    rho = 0.7
    want = fused_elementwise_step(*(jnp.asarray(a, jnp.float32) for a in (x, ux, uy, hty)),
                                  jnp.float32(rho), jnp.float32(tau), iso, iso_mode)
    got = t_fused.fused_elementwise_step(*(torch.from_numpy(a) for a in (x, ux, uy, hty)),
                                         rho, tau, iso, iso_mode)
    for g, w, atol in ((got[0], want[0], 1e-5), (got[3], want[3], 1e-6), (got[4], want[4], 1e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_fused_step_clamps_negative_tau(rng):
    """tau < 0 runs as tau = 0 (the clip form needs tau >= 0)."""
    x, ux, uy, hty = (torch.from_numpy(a) for a in _planes(rng, 4))
    got = t_fused.fused_elementwise_step(x, ux, uy, hty, 0.7, -0.2, False, "joint")
    want = t_solver._elementwise_step(x, ux, uy, hty, 0.7, 0.0, False, "joint")
    for i in (0, 3, 4):
        torch.testing.assert_close(got[i], want[i], rtol=0, atol=0)


def test_fused_step_rejects_compat(rng):
    x = torch.zeros(1, 1, 4, 4)
    with pytest.raises(ValueError):
        t_fused.fused_elementwise_step(x, x, x, x, 1.0, 0.1, True, "compat")


def test_fused_step_is_forward_only(rng):
    x, ux, uy, hty = (torch.from_numpy(a) for a in _planes(rng, 4))
    x.requires_grad_(True)
    s, *_ = t_fused.fused_elementwise_step(x, ux, uy, hty, 0.7, 0.1, False, "joint")
    with pytest.raises(RuntimeError, match="inference-only"):
        s.sum().backward()


# K2: the TPU test's bar (tests/test_vmem_solver.py:30): the JAX kernel's
# bf16x3 products against float32 products, over <= 20 iterations
@pytest.mark.parametrize(
    "case",
    ["aniso", "joint", "sample", "gauss_psf", "motion_psf", "maxit0"],
)
def test_whole_solve_matches_jax(rng, case):
    shape, lmbd, rho, kern, iso, iso_mode, maxit = SHAPE, 0.05, 0.8, None, False, "joint", 20
    if case == "joint":
        iso, maxit = True, 15
    elif case == "sample":
        iso, iso_mode, maxit = True, "sample", 15
    elif case in ("gauss_psf", "motion_psf"):
        shape, lmbd, rho = (1, 2, 16, 128), 0.01, 1.0
        kern = oracle.gaussian_psf(5, 1.0).astype(np.float32) if case == "gauss_psf" else _motion_psf()
    elif case == "maxit0":
        maxit = 0
    x = _noisy(rng, shape)
    k_j = None if kern is None else jnp.asarray(kern, jnp.float32)
    want = np.asarray(admm_tv_vmem(jnp.asarray(x, jnp.float32), lmbd, rho, k_j, iso=iso,
                                   maxit=maxit, iso_mode=iso_mode))
    k_t = None if kern is None else torch.from_numpy(kern)
    got = t_vmem.admm_tv_vmem(torch.from_numpy(x), lmbd, rho, k_t, iso=iso, maxit=maxit,
                              iso_mode=iso_mode, device="cpu").numpy()
    if case == "maxit0":
        np.testing.assert_array_equal(got, 0.0)
        np.testing.assert_array_equal(want, 0.0)
    else:
        np.testing.assert_allclose(got, want, atol=3e-4)


def test_whole_solve_mixed_matches_jax_mixed(rng):
    """'mixed' against JAX 'mixed' only (its iterates differ from 'high').
    Both round the same operands to bf16 but sum in float32 in different
    orders, so a bf16 rounding flips by one ulp (~4e-3 relative) on some
    elements of the fast phase; the 30-iteration exact tail contracts that.
    Tolerance 2.5e-4: measured 0.6e-4 to 1.2e-4 over three seeds, where
    'mixed' itself sits 3.6e-4 to 4.6e-4 from 'high' at these settings."""
    x = _noisy(rng, (1, 2, 16, 128))
    args = (0.05, 0.8, None)
    kw = dict(iso=False, maxit=60, precision="mixed", fast_frac=0.5)
    want = np.asarray(admm_tv_vmem(jnp.asarray(x, jnp.float32), *args, **kw))
    got = t_vmem.admm_tv_vmem(torch.from_numpy(x), *args, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2.5e-4)
    high = t_vmem.admm_tv_vmem(torch.from_numpy(x), *args, iso=False, maxit=60,
                               device="cpu").numpy()
    assert np.abs(got - high).max() > 2.5e-4


def test_whole_solve_picks_transform_by_psf_symmetry():
    gauss = torch.from_numpy(oracle.gaussian_psf(5, 1.0).astype(np.float32))
    x = torch.zeros(1, 1, 8, 8)
    assert len(t_vmem.solve_inputs(x, 0.1, 1.0, None)[-1]) == 2
    assert len(t_vmem.solve_inputs(x, 0.1, 1.0, gauss)[-1]) == 2
    assert len(t_vmem.solve_inputs(x, 0.1, 1.0, torch.from_numpy(_motion_psf()))[-1]) == 4


def test_whole_solve_is_forward_only(rng):
    x = torch.from_numpy(_noisy(rng, (1, 1, 8, 16))).requires_grad_(True)
    out = t_vmem.admm_tv_vmem(x, 0.05, 0.8, None, maxit=3, device="cpu")
    with pytest.raises(RuntimeError, match="inference-only"):
        out.sum().backward()


def test_wrappers_reject_cpu_default_without_cuda():
    """device=None means CUDA; without a card the entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_vmem.admm_tv_vmem(torch.zeros(1, 1, 8, 8), 0.05, 0.8)
