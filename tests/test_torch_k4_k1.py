"""K4 (the clustered interleaved solve, ``csrc/vmem_interleaved.cu``) and K1
(the tiled fused step, ``csrc/fused_admm.cu``) on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there). Here:

- K4's tensor-core numerics, emulated in torch: the left-first transform
  with 3xTF32 products, T_h' v read as the rows of T_h v permuted
  k -> (H - k) % H, and the Hartley pair's two right products summed in one
  accumulator, as the kernel computes them. Each CTA sums a product over
  the depth in chunks of 32, starting at a chunk of its own (so that CTAs
  do not ask for the same lines at once): the emulation sums its chunks in
  that rotated order, the hi products in float32 apart from the small terms.
- The interleaved schedule's plain version against the JAX interleaved
  kernel in interpret mode at 1, 3 and 7 planes, and against K2's plain
  version at shapes the TPU kernel refuses.
- K1's plain version against JAX at edge shapes, and the wrapper's
  handling of rho and tau.
- The ctypes parameter lists against the C entry points' signatures.

Inputs come from numpy seeds and are cast to float32 for JAX
(tests/conftest.py turns on x64).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_tc_numerics import mm_bf16, split
from torch_admm_deconv_tpu_torch.kernels import fused_admm as t_fused
from torch_admm_deconv_tpu_torch.kernels import vmem_solver as t_vmem

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from torch_admm_deconv_tpu.kernels import vmem_solver as j_vmem  # noqa: E402
from torch_admm_deconv_tpu.kernels.fused_admm import fused_elementwise_step  # noqa: E402

CSRC = Path(t_fused.__file__).resolve().parent.parent / "csrc"


def _noisy(rng, shape):
    return (rng.normal(size=shape) * 0.1 + 0.5).astype(np.float32)


def _motion_psf():
    k = np.zeros((1, 1, 5, 5), np.float32)
    k[0, 0, 2, 1:5] = [0.4, 0.3, 0.2, 0.1]  # one-sided: the Hartley pair
    return k


# --- K4: the tensor-core transform of the clustered kernel -------------------


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


def test_thp_is_th_with_its_rows_permuted():
    """The kernel reads T_h v in place of T_h' v (ops/hartley.py)."""
    th, thp, _, _ = t_vmem.cas_pair_mats(12, 10)
    perm = [(12 - k) % 12 for k in range(12)]
    assert torch.equal(thp, th[perm])


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


# --- K4: the interleaved schedule against JAX and K2 ------------------------


@pytest.mark.parametrize("shape,pack", [((1, 1, 16, 128), 1), ((1, 3, 16, 128), 3),
                                        ((1, 7, 8, 128), 7)])
@pytest.mark.parametrize("iso", [False, True])
def test_interleaved_plane_counts_match_jax(rng, shape, pack, iso):
    """1, 3 and 7 planes: one packed group each on the TPU (``pack``), one
    cluster per plane in K4. 'high', the JAX interleaved bar: 2e-4."""
    assert t_vmem._fixed_pack(shape, iso, "joint") == pack
    x = _noisy(rng, shape)
    kw = dict(iso=iso, maxit=20, iso_mode="joint", schedule="interleaved")
    want = np.asarray(j_vmem.admm_tv_vmem(jnp.asarray(x, jnp.float32), 0.05, 0.8, None, **kw))
    got = t_vmem.admm_tv_vmem(torch.from_numpy(x), 0.05, 0.8, None, device="cpu", **kw)
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("shape,psf,maxit", [((1, 2, 24, 40), None, 30),
                                             ((1, 2, 24, 40), "motion", 30),
                                             ((2, 3, 25, 19), None, 1),
                                             ((1, 1, 3, 5), None, 10)])
def test_interleaved_matches_k2_where_the_tpu_kernel_refuses(rng, shape, psf, maxit):
    """Shapes JAX's tile gate refuses (H % 8, W % 128): K4's plain version
    against K2's, 2e-4 (the two differ only in the transform's stage order)."""
    x = torch.from_numpy(_noisy(rng, shape))
    kern = None if psf is None else torch.from_numpy(_motion_psf())
    kw = dict(iso=False, maxit=maxit, device="cpu")
    inter = t_vmem.admm_tv_vmem(x, 0.05, 0.8, kern, schedule="interleaved", **kw)
    batched = t_vmem.admm_tv_vmem(x, 0.05, 0.8, kern, **kw)
    assert torch.isfinite(inter).all()
    assert float((inter - batched).abs().max()) <= 2e-4


def test_interleaved_maxit0_is_zero(rng):
    x = torch.from_numpy(_noisy(rng, (1, 2, 8, 8)))
    out = t_vmem.admm_tv_vmem(x, 0.05, 0.8, None, maxit=0, schedule="interleaved", device="cpu")
    assert torch.equal(out, torch.zeros_like(x))


# --- K1 ----------------------------------------------------------------------

EDGE_SHAPES = [(1, 3, 5, 7), (2, 3, 9, 13), (1, 2, 16, 38), (1, 1, 1, 3)]
MODES = [(False, "joint"), (True, "sample"), (True, "joint")]


@pytest.mark.parametrize("shape", EDGE_SHAPES)
@pytest.mark.parametrize("iso,iso_mode", MODES)
def test_fused_step_edge_shapes_match_jax(rng, shape, iso, iso_mode):
    """Sub-tile planes, odd W, W not a multiple of 4: the TPU test's
    tolerances (tests/test_fused_kernel.py:33-35)."""
    x, ux, uy, hty = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    want = fused_elementwise_step(*(jnp.asarray(a, jnp.float32) for a in (x, ux, uy, hty)),
                                  jnp.float32(0.7), jnp.float32(0.15), iso, iso_mode)
    got = t_fused.fused_elementwise_step(*(torch.from_numpy(a) for a in (x, ux, uy, hty)),
                                         0.7, 0.15, iso, iso_mode)
    for g, w, atol in ((got[0], want[0], 1e-5), (got[3], want[3], 1e-6), (got[4], want[4], 1e-6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_fused_step_takes_tensor_scalars(rng):
    """rho and tau as 0-d tensors (the solver loop's form) give the same
    result as numbers; a negative tensor tau runs as 0."""
    x, ux, uy, hty = (torch.from_numpy(rng.normal(size=(1, 3, 6, 10)).astype(np.float32))
                      for _ in range(4))
    a = t_fused.fused_elementwise_step(x, ux, uy, hty, 0.7, 0.0, True, "sample")
    b = t_fused.fused_elementwise_step(x, ux, uy, hty, torch.tensor(0.7), torch.tensor(-0.3),
                                       True, "sample")
    for i in (0, 3, 4):
        torch.testing.assert_close(a[i], b[i], rtol=0, atol=0)


def test_fused_step_scalar_is_a_float32_copy_or_refused():
    """The launch's rho and tau: a tensor of another type or device comes
    back as the float32 copy itself (the caller holds it until the kernel
    is launched), a number passes by value, more than one element raises."""
    like = torch.zeros(1, 1, 2, 2)
    t, v = t_fused._scalar(torch.tensor(0.7, dtype=torch.float64), like)
    assert t.dtype == torch.float32 and t.device == like.device and v == 0.0
    assert float(t) == np.float32(0.7)
    assert t_fused._scalar(0.25, like) == (None, 0.25)
    with pytest.raises(ValueError, match="scalars"):
        t_fused._scalar(torch.tensor([0.7, 0.15]), like)


# --- the C entry points' parameter lists ------------------------------------

ENTRY_POINTS = {
    "fused_admm_step": ("fused_admm.cu", t_fused.ARGTYPES),
    "admm_tv_vmem_solve": ("vmem_solver.cu", t_vmem.FIXED_ARGTYPES),
    "admm_tv_vmem_interleaved": ("vmem_interleaved.cu", t_vmem.INTERLEAVED_ARGTYPES),
    "admm_tv_adaptive_solve": ("vmem_adaptive.cu", t_vmem.ADAPTIVE_ARGTYPES),
}


def _c_params(source: str, name: str):
    text = (CSRC / source).read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
    assert m, f"{name} not found in {source}"
    kinds = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append("pointer")
        elif param.startswith("int "):
            kinds.append("int")
        elif param.startswith("float "):
            kinds.append("float")
        else:
            raise AssertionError(f"{name}: unexpected parameter {param!r}")
    return kinds


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_ctypes_parameters_match_the_c_signature(name):
    """ctypes passes what argtypes says: a pointer declared as an int would
    be cut to 32 bits, a float passed as an int reinterpreted."""
    import ctypes

    source, argtypes = ENTRY_POINTS[name]
    kind = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_float: "float"}
    assert [kind[a] for a in argtypes] == _c_params(source, name)
