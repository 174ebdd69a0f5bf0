"""The port's solver operators and ``admm_tv`` held against the JAX package
and the float64 NumPy oracle, on the CPU.

Inputs are made with numpy from a seed and cast to float32 explicitly for
JAX (tests/conftest.py turns on x64).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.kernels import fused_admm as t_fused
from torch_admm_deconv_tpu_torch.kernels import vmem_solver as t_vmem
from torch_admm_deconv_tpu_torch.ops import fdops as t_fd
from torch_admm_deconv_tpu_torch.ops import hartley as t_hart
from torch_admm_deconv_tpu_torch.ops import prox as t_prox
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv as t_admm_tv

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tests.oracles import numpy_admm as oracle  # noqa: E402
from torch_admm_deconv_tpu.ops import fdops as j_fd  # noqa: E402
from torch_admm_deconv_tpu.ops import mxu_fft as j_mxu  # noqa: E402
from torch_admm_deconv_tpu.ops import prox as j_prox  # noqa: E402
from torch_admm_deconv_tpu.ops.solver import admm_tv as j_admm_tv  # noqa: E402


def _f32(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _noisy(rng, shape):
    return (rng.normal(size=shape) * 0.1 + 0.5).astype(np.float32)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def _motion_psf():
    k = np.zeros((1, 1, 5, 5), np.float32)
    k[0, 0, 2, 1:5] = [0.4, 0.3, 0.2, 0.1]
    return k


# -- prox and fdops: the same float32 formulas, elementwise: 1e-6 -------------


@pytest.mark.parametrize("name", ["soft", "hard", "block_compat", "block_sample", "joint", "pixelnorm"])
def test_prox_matches_jax(rng, name):
    a, b = _f32(rng, (2, 3, 8, 8)), _f32(rng, (2, 3, 8, 8))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tau = 0.3
    if name == "soft":
        got, want = t_prox.soft_thresh(ta, tau), j_prox.soft_thresh(_j(a), tau)
    elif name == "hard":
        got, want = t_prox.hard_thresh(ta, tau), j_prox.hard_thresh(_j(a), tau)
    elif name == "block_compat":
        got, want = t_prox.block_thresh(ta, tau), j_prox.block_thresh(_j(a), tau)
    elif name == "block_sample":
        got, want = t_prox.block_thresh(ta, tau, axis=(1,)), j_prox.block_thresh(_j(a), tau, axis=(1,))
    elif name == "pixelnorm":
        got, want = t_prox.pixelnorm(ta), j_prox.pixelnorm(_j(a))
    else:
        got = torch.cat(t_prox.block_thresh_joint(ta, tb, tau))
        want = jnp.concatenate(j_prox.block_thresh_joint(_j(a), _j(b), tau))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", ["dx", "dy", "dx_t", "dy_t"])
def test_differences_match_jax(rng, name):
    a = _f32(rng, (2, 3, 8, 12))
    got = getattr(t_fd, name)(torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j_fd, name)(_j(a))))


@pytest.mark.parametrize("kern", ["none", "gauss", "motion"])
def test_frequency_operators_match_jax(rng, kern):
    shape = (16, 24)
    k = {"none": None, "gauss": oracle.gaussian_psf(5, 1.0).astype(np.float32),
         "motion": _motion_psf()}[kern]
    tk = None if k is None else torch.from_numpy(k)
    jk = None if k is None else _j(k)
    got = t_fd.freq_denominator(shape, 0.8, tk)
    want = j_fd.freq_denominator(shape, jnp.float32(0.8), jk, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if k is None:
        return
    x = _f32(rng, (2, 3) + shape)
    got = t_fd.htran_fft(torch.from_numpy(x), t_fd.psf_otf_centered(tk, shape), shape)
    want = j_fd.htran_fft(_j(x), j_fd.psf_otf_centered(jk, shape), shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if kern == "gauss":  # and H^T against the oracle's spatial correlation
        np.testing.assert_allclose(got.numpy(), oracle.htran(x.astype(np.float64), k), atol=1e-5)


def test_hartley_matrices_match_jax():
    for got, want in zip(t_hart.cas_pair_mats(8, 12), j_mxu.cas_pair_mats(8, 12)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(t_hart.cas_mats(8, 12), j_mxu.cas_mats(8, 12)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    half = np.random.default_rng(1).random((8, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        t_hart.mirror_freq_full_joint(torch.from_numpy(half), 12).numpy(),
        np.asarray(j_mxu.mirror_freq_full_joint(_j(half), 12)),
    )
    gauss = oracle.gaussian_psf(5, 1.0).astype(np.float32)
    for k in (None, gauss, _motion_psf()):
        tk = None if k is None else torch.from_numpy(k)
        assert t_hart.psf_is_axis_symmetric(tk) == j_mxu.psf_is_axis_symmetric(k)


# -- admm_tv -------------------------------------------------------------------


# the bar of tests/test_reference_parity.py:50, the oracle in float64
@pytest.mark.parametrize("iso", [False, True])
def test_admm_tv_matches_oracle_and_jax(rng, iso):
    x = _noisy(rng, (2, 3, 32, 32))
    got = t_admm_tv(torch.from_numpy(x), 0.05, 0.8, None, iso=iso, maxit=40, device="cpu").numpy()
    np.testing.assert_allclose(got, oracle.fft_admm_tv(x, 0.05, 0.8, None, iso=iso, maxit=40), atol=3e-4)
    want = np.asarray(j_admm_tv(_j(x), jnp.float32(0.05), jnp.float32(0.8), None, iso=iso, maxit=40,
                                fft_impl="xla"))
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_admm_tv_deblur_matches_oracle(rng):
    """tests/test_reference_parity.py:53-68's deblur case, oracle bar 5e-4."""
    psf = oracle.gaussian_psf(9, 1.5).astype(np.float32)
    x = _noisy(rng, (1, 3, 64, 64))
    got = t_admm_tv(torch.from_numpy(x), 0.01, 1.0, torch.from_numpy(psf), maxit=60, device="cpu")
    np.testing.assert_allclose(got.numpy(), oracle.fft_admm_tv(x, 0.01, 1.0, psf, maxit=60), atol=5e-4)


def test_compat_batch1_routes_to_sample_whole_solve(rng):
    """H1: 'compat' at batch 1 maps to 'sample' and takes the whole solve,
    as in JAX (solver.py:208-212); both agree with the loop's compat."""
    x = _noisy(rng, (1, 3, 16, 128))
    tx = torch.from_numpy(x)
    kw = dict(iso=True, maxit=15, iso_mode="compat")
    with mock.patch.object(t_vmem, "admm_tv_vmem", wraps=t_vmem.admm_tv_vmem) as spy:
        got = t_admm_tv(tx, 0.05, 0.8, None, use_pallas=True, device="cpu", **kw).numpy()
    assert spy.call_count == 1 and spy.call_args.kwargs["iso_mode"] == "sample"
    want = np.asarray(j_admm_tv(_j(x), jnp.float32(0.05), jnp.float32(0.8), None, use_pallas=True, **kw))
    np.testing.assert_allclose(got, want, atol=3e-4)
    loop = t_admm_tv(tx, 0.05, 0.8, None, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, loop, atol=3e-4)


def test_compat_batch2_stays_on_the_loop(rng):
    """At batch 2 'compat' couples the batch: no kernel, the loop runs
    (with the plain step: K1 rejects compat), held to JAX and the oracle."""
    x = _noisy(rng, (2, 3, 32, 32))
    with mock.patch.object(t_vmem, "admm_tv_vmem") as whole, \
            mock.patch.object(t_fused, "fused_elementwise_step") as fused:
        got = t_admm_tv(torch.from_numpy(x), 0.05, 0.8, None, iso=True, maxit=40,
                        use_pallas=True, device="cpu").numpy()
    assert whole.call_count == 0 and fused.call_count == 0
    np.testing.assert_allclose(got, oracle.fft_admm_tv(x, 0.05, 0.8, None, iso=True, maxit=40), atol=3e-4)
    want = np.asarray(j_admm_tv(_j(x), jnp.float32(0.05), jnp.float32(0.8), None, iso=True, maxit=40,
                                use_pallas=True))
    np.testing.assert_allclose(got, want, atol=3e-4)


@pytest.mark.parametrize("iso,iso_mode", [(False, "compat"), (True, "sample"), (True, "joint")])
def test_remat_with_pallas_runs_the_fused_step(rng, iso, iso_mode):
    """use_pallas with remat=True takes the loop with K1 as its step, as
    JAX does (solver.py:265-269); same result as the plain loop."""
    x = torch.from_numpy(_noisy(rng, (1, 2, 16, 32)))
    kw = dict(iso=iso, maxit=10, iso_mode=iso_mode, device="cpu")
    with mock.patch.object(t_fused, "fused_elementwise_step",
                           wraps=t_fused.fused_elementwise_step) as spy:
        got = t_admm_tv(x, 0.05, 0.8, None, use_pallas=True, remat=True, **kw)
    assert spy.call_count == 10
    torch.testing.assert_close(got, t_admm_tv(x, 0.05, 0.8, None, **kw), rtol=0, atol=1e-5)


def test_learned_psf_takes_the_differentiable_loop(rng):
    """A PSF with requires_grad under grad mode takes the loop (JAX: a
    traced kernel stays on the scan path); outside grad mode the whole
    solve."""
    x = torch.from_numpy(_noisy(rng, (1, 1, 16, 32)))
    psf = torch.from_numpy(oracle.gaussian_psf(3, 1.0).astype(np.float32)).requires_grad_(True)
    with mock.patch.object(t_vmem, "admm_tv_vmem", wraps=t_vmem.admm_tv_vmem) as spy:
        out = t_admm_tv(x, 0.05, 0.8, psf, maxit=5, use_pallas=False, device="cpu")
        out.sum().backward()
        assert psf.grad is not None
        t_admm_tv(x, 0.05, 0.8, psf, maxit=5, use_pallas=True, device="cpu")
        assert spy.call_count == 0
        with torch.no_grad():
            t_admm_tv(x, 0.05, 0.8, psf, maxit=5, use_pallas=True, device="cpu")
        assert spy.call_count == 1


def test_remat_gradients_match_jax(rng):
    """Gradients through the loop (checkpointed per iteration) against
    jax.grad of the scan, w.r.t. the input, lambda and rho."""
    x = _noisy(rng, (1, 2, 16, 16))
    tx = torch.from_numpy(x).requires_grad_(True)
    lm = torch.tensor(0.05, requires_grad=True)
    rh = torch.tensor(0.8, requires_grad=True)
    out = t_admm_tv(tx, lm, rh, None, iso=True, iso_mode="sample", maxit=8, remat=True, device="cpu")
    (out * out).sum().backward()

    def loss(xj, lj, rj):
        o = j_admm_tv(xj, lj, rj, None, iso=True, iso_mode="sample", maxit=8, fft_impl="xla")
        return jnp.sum(o * o)

    gx, gl, gr = jax.grad(loss, argnums=(0, 1, 2))(_j(x), jnp.float32(0.05), jnp.float32(0.8))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(float(lm.grad), float(gl), rtol=1e-3)
    np.testing.assert_allclose(float(rh.grad), float(gr), rtol=1e-3)
