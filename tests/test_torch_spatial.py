"""The port's row-split megapixel solver (``parallel/spatial.py``) on 4 gloo
ranks, held against the JAX package's ``shard_map`` solver on a 4-device
``space`` mesh and against the single-device solvers; it mirrors
tests/test_spatial.py. The ranks run every case once, in one group
(tests/_torch_dist.py); the inputs come from numpy seeds, in float32 on
both sides. The halo mode's result depends on the shard count, so port and
JAX halo solves are compared at the same count."""

from pathlib import Path

import numpy as np
import pytest
import torch

from tests._threads import one_torch_thread  # noqa: F401 (autouse)
from tests._torch_dist import run_ranks
from tests.oracles import numpy_admm as oracle
from torch_admm_deconv_tpu_torch.ops.solver import admm_tv, admm_tv_adaptive

N = 4  # ranks on the space axis, and devices of the JAX mesh

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")


def _img(rng, shape):
    return (rng.normal(size=shape) * 0.1 + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The inputs, and rank 0's results of every case."""
    rng = np.random.default_rng(42)
    inputs = {
        "fft_x": rng.normal(size=(2, 3, 32, 24)).astype(np.float32),  # (24//2+1) % 4 = 1
        "fft_x16": rng.normal(size=(1, 1, 16, 16)).astype(np.float32),  # (16//2+1) % 4 = 1
        "denoise_x": _img(rng, (2, 3, 32, 32)),
        "deblur_x": _img(rng, (1, 3, 64, 48)),
        "psf": oracle.gaussian_psf(9, 1.5).astype(np.float32),
        "halo_x": _img(rng, (1, 3, 128, 32)),
        "halo_deblur_x": _img(rng, (1, 3, 128, 48)),
        "decay_x": _img(rng, (1, 1, 128, 32)),
        "one_x": _img(rng, (1, 3, 32, 32)),
        "adapt_x": _img(rng, (1, 1, 64, 64)),
        "adapt_halo_x": _img(rng, (1, 1, 128, 64)),
    }
    workdir = tmp_path_factory.mktemp("spatial_ranks")
    np.savez(workdir / "inputs.npz", **inputs)
    return inputs, run_ranks("spatial", N, Path(workdir))[0]


def _mesh(n=N):
    from torch_admm_deconv_tpu.parallel import make_mesh

    return make_mesh((n,), ("space",))


def _jax_spatial(x, *args, **kwargs):
    from torch_admm_deconv_tpu.parallel import spatial_admm_tv

    kwargs.setdefault("mesh", _mesh())
    return np.asarray(spatial_admm_tv(jnp.asarray(x, jnp.float32), *args, **kwargs))


def _single(x, lmbd, rho, kern=None, **kwargs):
    kern = None if kern is None else torch.from_numpy(kern)
    return admm_tv(torch.from_numpy(x), lmbd, rho, kern, device="cpu", **kwargs).numpy()


def _err(a, b) -> float:
    return float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("w", ["24", "16"])
def test_distributed_fft_roundtrip(ranks, w):
    """rfft2_sharded then irfft2_sharded gives the rows back (1e-5, JAX's
    bar), with the column axis padded (W//2+1 not a multiple of 4)."""
    inputs, out = ranks
    x = inputs["fft_x" if w == "24" else "fft_x16"]
    assert _err(out[f"fft_roundtrip{w}"], x) <= 1e-5


@pytest.mark.parametrize("w", ["24", "16"])
def test_distributed_fft_matches_rfft2_and_jax(ranks, w):
    """The transposed pencil spectrum is ``rfft2`` on the real columns
    (1e-4, JAX's bar) and 0 on the padded ones, and JAX's
    ``rfft2_sharded`` on a 4-device mesh to 1e-6 of its largest entry (two
    float32 FFT libraries)."""
    from jax.sharding import PartitionSpec as P

    from torch_admm_deconv_tpu.parallel.spatial import rfft2_sharded

    inputs, out = ranks
    x = inputs["fft_x" if w == "24" else "fft_x16"]
    width = x.shape[-1]
    wf = width // 2 + 1
    got = out[f"fft_spec{w}"]
    assert got.shape == x.shape[:-1] + (wf + (-wf) % N,)
    np.testing.assert_allclose(got[..., :wf], np.fft.rfft2(x), atol=1e-4)
    assert np.all(got[..., wf:] == 0)
    fn = jax.jit(jax.shard_map(lambda v: rfft2_sharded(v, "space", N, width), mesh=_mesh(),
                               in_specs=P(None, None, "space", None),
                               out_specs=P(None, None, None, "space")))
    want = np.asarray(fn(jnp.asarray(x, jnp.float32)))
    assert _err(got, want) <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("iso,iso_mode", [(False, "compat"), (True, "compat"), (True, "sample"),
                                          (True, "joint")], ids=["aniso", "compat", "sample",
                                                                 "joint"])
def test_pencil_denoise_matches_single_device_and_jax(ranks, iso, iso_mode):
    """30 iterations on (2, 3, 32, 32): the unsharded port solve within
    2e-4 (JAX's bar against its own unsharded solve), JAX's pencil solve
    at 4 shards within 1e-5."""
    inputs, out = ranks
    key = "aniso" if not iso else iso_mode
    x = inputs["denoise_x"]
    got = out[f"pencil_{key}"]
    assert _err(got, _single(x, 0.05, 0.8, iso=iso, maxit=30, iso_mode=iso_mode)) <= 2e-4
    want = _jax_spatial(x, 0.05, 0.8, None, iso=iso, maxit=30, iso_mode=iso_mode)
    assert _err(got, want) <= 1e-5


def test_pencil_deblur_matches_single_device_and_jax(ranks):
    """9x9 Gaussian, 40 iterations on (1, 3, 64, 48): the OTF by columns
    keeps the unsharded port solve within 5e-4 (JAX's bar) and JAX's pencil
    solve within 1e-5."""
    inputs, out = ranks
    x, psf = inputs["deblur_x"], inputs["psf"]
    got = out["pencil_deblur"]
    assert _err(got, _single(x, 0.01, 1.0, psf, maxit=40)) <= 5e-4
    assert _err(got, _jax_spatial(x, 0.01, 1.0, jnp.asarray(psf), maxit=40)) <= 1e-5


@pytest.mark.parametrize("iso,iso_mode", [(False, "compat"), (True, "joint")],
                         ids=["aniso", "joint"])
def test_halo_denoise_matches_single_device_and_jax(ranks, iso, iso_mode):
    """128 rows over 4 ranks, a 16-row halo: the unsharded port solve within
    5e-4 (JAX's bar), JAX's halo solve at 4 shards within 1e-5."""
    inputs, out = ranks
    x = inputs["halo_x"]
    got = out["halo_aniso" if not iso else "halo_joint"]
    assert _err(got, _single(x, 0.05, 0.8, iso=iso, maxit=30, iso_mode=iso_mode)) <= 5e-4
    want = _jax_spatial(x, 0.05, 0.8, None, iso=iso, maxit=30, iso_mode=iso_mode,
                        x_update_mode="halo", halo=16)
    assert _err(got, want) <= 1e-5


def test_halo_deblur_matches_single_device_and_jax(ranks):
    """The halo deblur: the unsharded port solve within 1e-3 (JAX's bar),
    JAX's halo solve at 4 shards within 1e-5."""
    inputs, out = ranks
    x, psf = inputs["halo_deblur_x"], inputs["psf"]
    got = out["halo_deblur"]
    assert _err(got, _single(x, 0.01, 1.0, psf, maxit=40)) <= 1e-3
    want = _jax_spatial(x, 0.01, 1.0, jnp.asarray(psf), maxit=40, x_update_mode="halo", halo=16)
    assert _err(got, want) <= 1e-5


def test_halo_error_decays_with_margin(ranks):
    """The error against the unsharded solve falls as the halo grows
    (2 -> 8 -> 16), to below 5e-5 at 16 (JAX's bars)."""
    inputs, out = ranks
    single = _single(inputs["decay_x"], 0.05, 0.8, maxit=30)
    e2, e8, e16 = (_err(out[f"decay_{m}"], single) for m in (2, 8, 16))
    assert e2 > e8 > e16, (e2, e8, e16)
    assert e16 < 5e-5, e16


def test_halo_one_shard(ranks):
    """One shard (a (4, 1) data x space mesh): the pad is the block's own
    wrap, so the (H+2m)-periodic solve is near the unsharded one (5e-5,
    JAX's bar) and equal to JAX's one-shard halo solve within 1e-5."""
    inputs, out = ranks
    x = inputs["one_x"]
    got = out["one_shard"]
    assert _err(got, _single(x, 0.05, 0.8, maxit=30)) <= 5e-5
    want = _jax_spatial(x, 0.05, 0.8, None, maxit=30, mesh=_mesh(1), x_update_mode="halo",
                        halo=16)
    assert _err(got, want) <= 1e-5


@pytest.mark.parametrize("mode", ["pencil", "halo"])
def test_adaptive_converges_jointly(ranks, mode):
    """The residual-stopped solve (tol 1e-4, adaptive rho): both residuals
    under tol before maxit; iterations within 1 of JAX's spatial solve at 4
    shards and of the unsharded port solve (JAX holds its halo form to 2 of
    the unsharded one); x within 5e-4 (pencil) and 1e-3 (halo) of the
    unsharded solve (JAX's bars) and 1e-5 of JAX's."""
    from torch_admm_deconv_tpu.parallel import spatial_admm_tv_adaptive

    inputs, out = ranks
    x = inputs["adapt_x" if mode == "pencil" else "adapt_halo_x"]
    halo = 32 if mode == "pencil" else 16
    got, (iters, r, s, _) = out[f"adaptive_{mode}"], out[f"adaptive_{mode}_stats"]
    assert iters < 300 and r <= 1e-4 and s <= 1e-4
    want = spatial_admm_tv_adaptive(jnp.asarray(x, jnp.float32), 0.05, 1.0, None, maxit=300,
                                    tol=1e-4, mesh=_mesh(), x_update_mode=mode, halo=halo)
    assert abs(iters - int(want.iters)) <= 1
    assert _err(got, np.asarray(want.x)) <= 1e-5
    ref = admm_tv_adaptive(torch.from_numpy(x), 0.05, 1.0, None, maxit=300, tol=1e-4,
                           device="cpu")
    assert abs(iters - int(ref.iters)) <= (1 if mode == "pencil" else 2)
    assert _err(got, ref.x.numpy()) <= (5e-4 if mode == "pencil" else 1e-3)


@pytest.mark.parametrize("case,match", [
    ("err_rows", "H=30 must divide over 4 spatial shards"),
    ("err_halo0", r"halo=0 must be in \(0, H/n=32\]"),
    ("err_halo_big", r"halo=33 must be in \(0, H/n=32\]"),
])
def test_shape_errors(ranks, case, match):
    """JAX's shape errors, raised as ValueError with its messages: H not a
    multiple of the shard count, and a halo outside (0, H/n]."""
    import re

    _, out = ranks
    assert re.fullmatch(match, str(out[case])), str(out[case])
