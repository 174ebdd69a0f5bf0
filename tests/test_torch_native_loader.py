"""The port's native C++ loader (``runtime/native.py``, built from
``csrc/dataloader.cc``) on the CPU: where it builds, its batches bit for bit
against the JAX package's ``NativeDataLoader`` at one worker thread (its
own library built from the JAX source into a temporary directory), the JAX
tests' contracts, and a failing compiler raising."""

import stat
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from torch_admm_deconv_tpu_torch.kernels import _build
from torch_admm_deconv_tpu_torch.runtime import native

j_native = pytest.importorskip("torch_admm_deconv_tpu.runtime.native")

REPO = Path(__file__).resolve().parent.parent
JAX_RUNTIME = REPO / "torch_admm_deconv_tpu" / "runtime"


def _snapshot(d: Path) -> dict:
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns) for p in sorted(d.iterdir())}


@pytest.fixture(scope="module")
def jax_before():
    return _snapshot(JAX_RUNTIME)


@pytest.fixture(scope="module")
def built(jax_before):
    assert native.ensure_built() is True
    return native.lib_path()


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory, jax_before):
    """The JAX package's loader on a library built from its own source with
    its Makefile's flags into a temporary directory (never into its
    ``runtime/``)."""
    out = tmp_path_factory.mktemp("jax_runtime") / "libtadruntime.so"
    subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared", "-o",
                    str(out), str(JAX_RUNTIME / "dataloader.cc"), "-lpng", "-ljpeg", "-lpthread"],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "_LIB_PATH", out)
        mp.setattr(j_native, "_lib", None)
        yield j_native


def _pairs(root: Path, rng, n=5, shape=(24, 28, 3), same=True, ext="png"):
    xd, yd = root / "x", root / "y"
    xd.mkdir(parents=True)
    yd.mkdir()
    for i in range(n):
        arr = (rng.random(shape) * 255).astype(np.uint8)
        other = arr if same else (rng.random(shape) * 255).astype(np.uint8)
        kw = {"quality": 95} if ext == "jpg" else {}
        Image.fromarray(arr).save(xd / f"im_{i}.{ext}", **kw)
        Image.fromarray(other).save(yd / f"im_{i}.{ext}", **kw)
    return xd, yd


def test_library_builds_into_the_ports_build_dir(built, jax_before, tmp_path, monkeypatch):
    """The library lands under the port's gitignored ``_build/``, keyed on
    the source and flags; a forced rebuild goes there too; nothing is
    written into the JAX package's ``runtime/``; the kernels' build key
    ignores the ``.cc`` source."""
    pkg = REPO / "torch_admm_deconv_tpu_torch"
    assert built.exists() and built.parent.parent == pkg / "_build"
    assert built.parent.name.startswith("runtime-") and native.is_available()
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    assert not native.is_available()
    assert native.ensure_built(force=True) is True
    assert native.lib_path().exists() and native.lib_path().parent.parent == tmp_path / "_build"
    assert _snapshot(JAX_RUNTIME) == jax_before
    assert not any(p.suffix == ".cc" for p in _build.CSRC.glob("*.cu*"))
    assert (pkg / "csrc" / "dataloader.cc").read_bytes() == (
        JAX_RUNTIME / "dataloader.cc").read_bytes()


@pytest.mark.parametrize("awgn", [(0, 0), (5, 20)], ids=["clean", "awgn"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_bit_equal_to_jax_at_one_thread(built, jax_lib, tmp_path, rng, awgn, shuffle):
    """One worker thread, seed 7, batch 2, 16 x 12 crops, two epochs over 5
    distinct pairs: every batch of x and y equal bit for bit."""
    xd, yd = _pairs(tmp_path, rng, same=False)
    kw = dict(batch_size=2, crop=(16, 12), awgn_std_range=awgn, shuffle=shuffle, seed=7,
              n_threads=1)
    port = native.NativeDataLoader.from_dirs(xd, yd, **kw)
    jax = jax_lib.NativeDataLoader.from_dirs(xd, yd, **kw)
    try:
        assert len(port) == len(jax) == 2
        for _ in range(2):
            for (px, py), (jx, jy) in zip(port, jax, strict=True):
                np.testing.assert_array_equal(px, jx)
                np.testing.assert_array_equal(py, jy)
                assert px.dtype == np.float32 and px.shape == (2, 3, 16, 12)
    finally:
        port.close()
        jax.close()


def test_shapes_and_pairing(built, tmp_path, rng):
    xd, yd = _pairs(tmp_path, rng)
    loader = native.NativeDataLoader.from_dirs(xd, yd, batch_size=2, crop=(16, 16), seed=7)
    assert len(loader) == 2
    x, y = loader.next_batch()
    assert x.shape == (2, 3, 16, 16) and x.dtype == np.float32
    np.testing.assert_allclose(x, y, atol=1e-6)  # x == y pairs, no noise: the same crop
    assert 0.0 <= x.min() and x.max() <= 1.0
    loader.close()


def test_awgn_applied_to_x_only(built, tmp_path, rng):
    xd, yd = _pairs(tmp_path, rng)
    loader = native.NativeDataLoader.from_dirs(xd, yd, batch_size=2, crop=(16, 16),
                                               awgn_std_range=(20, 25), seed=7)
    x, y = loader.next_batch()
    assert not np.allclose(x, y)
    assert 0.0 <= x.min() and x.max() <= 1.0
    assert 0.01 < np.abs(x - y).mean() < 0.2  # sigma 20-24/255
    loader.close()


def test_decodes_jpeg(built, tmp_path, rng):
    xd, yd = _pairs(tmp_path, rng, n=1, shape=(20, 20, 3), ext="jpg")
    loader = native.NativeDataLoader.from_dirs(xd, yd, batch_size=1, crop=(16, 16))
    x, y = loader.next_batch()
    assert x.shape == (1, 3, 16, 16)
    np.testing.assert_allclose(x, y, atol=1e-6)
    loader.close()


def test_iterates_epochs(built, tmp_path, rng):
    xd, yd = _pairs(tmp_path, rng)
    loader = native.NativeDataLoader.from_dirs(xd, yd, batch_size=2, crop=(8, 8), seed=3)
    count = 0
    for _ in range(2):  # two epochs: the internal reshuffle keeps feeding
        for x, y in loader:
            assert x.shape == (2, 3, 8, 8)
            count += 1
    assert count == 4
    loader.close()


def test_a_failing_compiler_raises(tmp_path, monkeypatch):
    """No fallback: a build that fails raises RuntimeError with the
    compiler's output, and no library appears."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'fatal error: png.h: No such file or directory' >&2\nexit 1\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="png.h: No such file"):
        native.ensure_built()
    assert not native.is_available()
    assert not any(p.name != ".lock" for p in native.lib_path().parent.iterdir())
    with pytest.raises(RuntimeError, match="building the native loader failed"):
        native.NativeDataLoader(["a.png"], ["b.png"], 1, (8, 8))


def test_unpaired_paths_raise(built):
    with pytest.raises(ValueError, match="as many x as y paths"):
        native.NativeDataLoader(["a.png", "b.png"], ["a.png"], 1, (8, 8))
    with pytest.raises(ValueError, match="as many x as y paths"):
        native.NativeDataLoader([], [], 1, (8, 8))
