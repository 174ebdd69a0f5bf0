"""The port's residual-stopped solvers held against the JAX package on the
CPU: K3 (``admm_tv_adaptive_vmem``, per-block stopping) and K4
(``admm_tv_vmem(schedule='interleaved')``) against the Pallas kernels in
interpret mode, and the loop solver ``admm_tv_adaptive`` and
``tv_objective`` against their JAX versions.

On the CPU each wrapper runs its kernel's plain version; the CUDA kernels
are held against the plain versions on the card by chip_smoke.py. Inputs
are made with numpy from a seed and cast to float32 explicitly for JAX
(tests/conftest.py turns on x64).
"""

import numpy as np
import pytest
import torch

from torch_admm_deconv_tpu_torch.kernels import vmem_solver as t_vmem
from torch_admm_deconv_tpu_torch.ops import solver as t_solver

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from tests.oracles import numpy_admm as oracle  # noqa: E402
from torch_admm_deconv_tpu.kernels import vmem_solver as j_vmem  # noqa: E402
from torch_admm_deconv_tpu.ops import solver as j_solver  # noqa: E402


def _noisy(rng, shape):
    return (rng.normal(size=shape) * 0.1 + 0.5).astype(np.float32)


def _motion_psf():
    k = np.zeros((1, 1, 5, 5), np.float32)
    k[0, 0, 2, 1:5] = [0.4, 0.3, 0.2, 0.1]  # one-sided: asymmetric
    return k


def _psf(name):
    if name == "gauss":
        return oracle.gaussian_psf(5, 1.0).astype(np.float32)
    return _motion_psf() if name == "motion" else None


def _both_adaptive(x, lmbd, rho, kern, **kw):
    k_j = None if kern is None else jnp.asarray(kern, jnp.float32)
    k_t = None if kern is None else torch.from_numpy(kern)
    want = j_vmem.admm_tv_adaptive_vmem(jnp.asarray(x, jnp.float32), lmbd, rho, k_j, **kw)
    got = t_vmem.admm_tv_adaptive_vmem(torch.from_numpy(x), lmbd, rho, k_t, device="cpu", **kw)
    return got, want


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


# K3, 'high': JAX's bf16x3 products against the port's float32 (the K2 bar
# of tests/test_vmem_solver.py:30 is 3e-4 over 20 iterations): x 2e-4;
# the stopping decisions agree exactly, and the exit residuals and rho to
# 1e-3 relative (measured <= 3e-4)
K3_CASES = {
    # name: (shape, lmbd, rho, psf, iso, iso_mode)
    "aniso": ((2, 3, 16, 128), 0.05, 0.8, None, False, "sample"),
    "joint": ((2, 3, 16, 128), 0.05, 0.8, None, True, "joint"),
    "sample": ((2, 3, 16, 128), 0.05, 0.8, None, True, "sample"),
    "adaptive_rho": ((1, 2, 16, 128), 0.05, 0.05, None, False, "sample"),
    "gauss_psf": ((1, 2, 16, 128), 0.01, 1.0, "gauss", False, "sample"),
    "motion_psf": ((1, 2, 16, 128), 0.01, 1.0, "motion", False, "sample"),
}


@pytest.mark.parametrize("case", sorted(K3_CASES))
def test_adaptive_whole_solve_matches_jax(rng, case):
    shape, lmbd, rho, psf, iso, iso_mode = K3_CASES[case]
    x = _noisy(rng, shape)
    got, want = _both_adaptive(x, lmbd, rho, _psf(psf), iso=iso, iso_mode=iso_mode,
                               maxit=300, tol=1e-3, precision="high")
    n_blocks = shape[0] if iso and iso_mode == "sample" else shape[0] * shape[1]
    assert got.iters.dtype == torch.int32 and got.iters.shape == (n_blocks,)
    for v in (got.r_norm, got.s_norm, got.rho):
        assert v.dtype == torch.float32 and v.shape == (n_blocks,)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert (got.iters.numpy() < 300).all()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=2e-4)
    for name in ("r_norm", "s_norm", "rho"):
        assert _rel(getattr(got, name).numpy(), getattr(want, name)) <= 1e-3, name
    if case == "adaptive_rho":
        assert (got.rho.numpy() != 0.05).all()  # residual balancing moved rho


# 'mixed': the fast phase rounds operands to bf16 on both sides, summed in
# other orders, so a one-ulp flip can move the switch or exit by an
# iteration: iters within 2, the tol contract, x within 5e-3 (the JAX
# mixed-vs-high bar, tests/test_vmem_solver.py:215)
@pytest.mark.parametrize("psf", [None, "motion"])
def test_adaptive_whole_solve_mixed_matches_jax(rng, psf):
    x = _noisy(rng, (1, 2, 16, 128))
    lmbd, rho = (0.05, 0.8) if psf is None else (0.01, 1.0)
    got, want = _both_adaptive(x, lmbd, rho, _psf(psf), iso=False, maxit=300, tol=1e-3,
                               precision="mixed")
    assert np.abs(got.iters.numpy() - np.asarray(want.iters)).max() <= 2
    assert (got.iters.numpy() < 300).all()
    assert (got.r_norm.numpy() <= 1e-3).all() and (got.s_norm.numpy() <= 1e-3).all()
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=5e-3)


def test_adaptive_whole_solve_exit_state_matches_jax(rng):
    """return_state with residual balancing off: the exit state (x, z, u)
    matches JAX's and final rho equals rho0 exactly."""
    x = _noisy(rng, (1, 3, 16, 128))
    kw = dict(iso=True, iso_mode="sample", maxit=400, tol=1e-5, rho_mu=1e30, precision="high",
              return_state=True)
    (got, got_state), (want, want_state) = _both_adaptive(x, 0.05, 0.8, None, **kw)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    np.testing.assert_array_equal(got.rho.numpy(), np.float32(0.8))
    assert len(got_state) == 5
    for g, w in zip(got_state, want_state):
        assert g.shape == x.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)
    torch.testing.assert_close(got_state[0], got.x, rtol=0, atol=0)


def test_adaptive_whole_solve_maxit0(rng):
    x = _noisy(rng, (1, 2, 16, 128))
    got, want = _both_adaptive(x, 0.05, 0.8, None, iso=False, maxit=0)
    np.testing.assert_array_equal(got.x.numpy(), 0.0)
    np.testing.assert_array_equal(np.asarray(want.x), 0.0)
    np.testing.assert_array_equal(got.iters.numpy(), 0)
    np.testing.assert_array_equal(got.r_norm.numpy(), 1.0)
    np.testing.assert_array_equal(got.s_norm.numpy(), 1.0)
    np.testing.assert_array_equal(got.rho.numpy(), np.float32(0.8))


def test_adaptive_whole_solve_rejects_compat_and_bad_precision():
    x = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError):
        t_vmem.admm_tv_adaptive_vmem(x, 0.05, 0.8, iso=True, iso_mode="compat", device="cpu")
    with pytest.raises(ValueError):
        t_vmem.admm_tv_adaptive_vmem(x, 0.05, 0.8, precision="low", device="cpu")


def test_adaptive_whole_solve_is_forward_only(rng):
    x = torch.from_numpy(_noisy(rng, (1, 1, 8, 16))).requires_grad_(True)
    res = t_vmem.admm_tv_adaptive_vmem(x, 0.05, 0.8, maxit=3, device="cpu")
    with pytest.raises(RuntimeError, match="inference-only"):
        res.x.sum().backward()


def test_adaptive_schedule_matches_the_tpu_mixed_phase():
    """The mixed phase's switch and cap (JAX vmem_solver.py:858-864)."""
    cfg = t_vmem.adaptive_config((1, 3, 8, 8), True, "sample", 2000, 1e-5, 10.0, 2.0, "mixed",
                                 None, False)
    assert cfg.g == 3 and cfg.fast_switch == 1e-2 and cfg.fast_cap == 2000 - 250
    assert cfg.use_fast and cfg.adapt
    cfg = t_vmem.adaptive_config((1, 3, 8, 8), False, "sample", 60, 1e-3, 1e30, 2.0, "mixed",
                                 None, False)
    assert cfg.g == 1 and cfg.fast_switch == 2e-2 and cfg.fast_cap == 52
    assert not cfg.adapt
    high = t_vmem.adaptive_config((1, 3, 8, 8), False, "sample", 60, 1e-3, 10.0, 2.0, "high",
                                  None, False)
    assert not high.use_fast


# K4: the interleaved schedule. 'high': the JAX interleaved kernel's bar
# against its batched kernel (tests/test_vmem_solver.py:184), 2e-4.
@pytest.mark.parametrize("iso,iso_mode,psf", [(False, "joint", None), (True, "joint", None),
                                              (False, "joint", "motion")])
def test_interleaved_schedule_matches_jax(rng, iso, iso_mode, psf):
    kern = _psf(psf)
    x = _noisy(rng, (2, 3, 16, 128) if psf is None else (1, 2, 16, 128))
    kw = dict(iso=iso, maxit=40, iso_mode=iso_mode, schedule="interleaved")
    k_j = None if kern is None else jnp.asarray(kern, jnp.float32)
    want = np.asarray(j_vmem.admm_tv_vmem(jnp.asarray(x, jnp.float32), 0.05, 0.8, k_j, **kw))
    k_t = None if kern is None else torch.from_numpy(kern)
    got = t_vmem.admm_tv_vmem(torch.from_numpy(x), 0.05, 0.8, k_t, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_interleaved_schedule_mixed_matches_jax(rng):
    """'mixed' against JAX's interleaved 'mixed', the K2 'mixed' bar of
    tests/test_torch_kernels.py (60 iterations, half fast): 2.5e-4. The
    left-first transform rounds at other points than K2's, so the two
    schedules differ by more than that in 'mixed'."""
    x = _noisy(rng, (1, 2, 16, 128))
    kw = dict(iso=False, maxit=60, precision="mixed", fast_frac=0.5, schedule="interleaved")
    want = np.asarray(j_vmem.admm_tv_vmem(jnp.asarray(x, jnp.float32), 0.05, 0.8, None, **kw))
    got = t_vmem.admm_tv_vmem(torch.from_numpy(x), 0.05, 0.8, None, device="cpu", **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2.5e-4)


def test_interleaved_sample_runs_batched(rng):
    """'sample' couples a sample's planes: the interleaved schedule runs
    the batched solve, as in JAX (vmem_solver.py:1029)."""
    x = torch.from_numpy(_noisy(rng, (2, 3, 16, 128)))
    kw = dict(iso=True, iso_mode="sample", maxit=15, device="cpu")
    inter = t_vmem.admm_tv_vmem(x, 0.05, 0.8, None, schedule="interleaved", **kw)
    batched = t_vmem.admm_tv_vmem(x, 0.05, 0.8, None, **kw)
    torch.testing.assert_close(inter, batched, rtol=0, atol=0)


def test_schedule_is_checked():
    with pytest.raises(ValueError, match="schedule"):
        t_vmem.admm_tv_vmem(torch.zeros(1, 1, 8, 8), 0.05, 0.8, schedule="pipelined",
                            device="cpu")


@pytest.mark.parametrize("shape,pack", [((8, 3, 256, 256), 8), ((1, 3, 256, 256), 3),
                                        ((2, 3, 16, 128), 6), ((1, 7, 8, 8), 7)])
def test_interleaved_groups_follow_the_tpu_packing(shape, pack):
    """K4's stream groups are the TPU kernel's grid programs
    (JAX _fixed_pack, vmem_solver.py:454-476, cap 8)."""
    assert t_vmem._fixed_pack(shape, False, "joint") == pack
    assert j_vmem._fixed_pack(shape, False, "joint", False) == pack


# the loop solver: the same torch.fft / XLA FFT loop in float32, one global
# stopping decision: iters equal, x 1e-5, residuals and rho 1e-4 relative.
# The dual residual is the norm of a difference of two z iterates (about
# 1e-5 at exit), so the two FFT libraries' roundoff in z reaches ~1e-4 of
# it: r and s get an absolute floor of 1e-8 beside the relative bar.
@pytest.mark.parametrize("iso,iso_mode,psf,rho", [
    (False, "sample", None, 0.8), (True, "sample", None, 0.05), (True, "joint", "gauss", 1.0),
    (True, "compat", None, 3.0), (False, "sample", "motion", 1.0),
])
def test_admm_tv_adaptive_matches_jax(rng, iso, iso_mode, psf, rho):
    x = _noisy(rng, (2, 3, 16, 16))
    kern = _psf(psf)
    k_j = None if kern is None else jnp.asarray(kern, jnp.float32)
    k_t = None if kern is None else torch.from_numpy(kern)
    kw = dict(iso=iso, iso_mode=iso_mode, maxit=300, tol=1e-4)
    want = j_solver.admm_tv_adaptive(jnp.asarray(x, jnp.float32), 0.05, rho, k_j, **kw)
    got = t_solver.admm_tv_adaptive(torch.from_numpy(x), 0.05, rho, k_t, device="cpu", **kw)
    assert int(got.iters) == int(want.iters) and int(got.iters) < 300
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)
    for name in ("r_norm", "s_norm"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-8, err_msg=name)
    assert _rel(got.rho.numpy(), want.rho) <= 1e-4
    # tv_objective on the solution: the same float32 sums, 1e-5 relative
    obj_j = j_solver.tv_objective(want.x, jnp.asarray(x, jnp.float32), 0.05, k_j, iso)
    obj_t = t_solver.tv_objective(got.x, torch.from_numpy(x), 0.05, k_t, iso, device="cpu")
    assert _rel(obj_t.numpy(), obj_j) <= 1e-5


def test_admm_tv_adaptive_fixed_rho_and_chw(rng):
    x = _noisy(rng, (3, 16, 16))
    kw = dict(maxit=200, tol=1e-4, adapt_rho=False)
    want = j_solver.admm_tv_adaptive(jnp.asarray(x, jnp.float32), 0.05, 0.1, None, **kw)
    got = t_solver.admm_tv_adaptive(torch.from_numpy(x), 0.05, 0.1, None, device="cpu", **kw)
    assert got.x.shape == x.shape and float(got.rho) == np.float32(0.1)
    assert int(got.iters) == int(want.iters)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), atol=1e-5)


def test_admm_tv_adaptive_psum_axis_not_ported(rng, tmp_path):
    """``psum_axis`` is ported: it takes a process group (or a mesh and an
    axis), not JAX's bare axis name. Over a one-rank gloo group the sums
    are this rank's, so the solve is the ungrouped one exactly; the
    multi-rank semantics are held in tests/test_torch_data_parallel.py."""
    import torch.distributed as dist

    x = torch.from_numpy((rng.normal(size=(2, 1, 16, 16)) * 0.1 + 0.5).astype(np.float32))
    with pytest.raises(ValueError, match="names a mesh axis"):
        t_solver.admm_tv_adaptive(x, 0.05, 0.8, psum_axis="space", device="cpu")
    want = t_solver.admm_tv_adaptive(x, 0.05, 0.8, maxit=100, tol=1e-4, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        got = t_solver.admm_tv_adaptive(x, 0.05, 0.8, maxit=100, tol=1e-4,
                                        psum_axis=dist.group.WORLD, device="cpu")
    finally:
        dist.destroy_process_group()
    assert int(got.iters) == int(want.iters)
    assert torch.equal(got.x, want.x) and torch.equal(got.rho, want.rho)


def test_adaptive_entry_points_default_to_cuda():
    """device=None means CUDA; without a card each entry point raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = torch.zeros(1, 1, 8, 8)
    for call in (lambda: t_solver.admm_tv_adaptive(x, 0.05, 0.8),
                 lambda: t_vmem.admm_tv_adaptive_vmem(x, 0.05, 0.8),
                 lambda: t_solver.tv_objective(x, x, 0.05)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
