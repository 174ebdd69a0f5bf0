"""ctypes bindings for the native C++ data-loading runtime.

Counterpart of torch_admm_deconv_tpu/runtime/native.py. ``NativeDataLoader``
keeps the iterator contract of ``data.DataLoader``: it yields float32 NCHW
``(x, y)`` numpy batch pairs, which ``NNTrainer`` copies to the device once a
step, but decodes PNG and JPEG and applies the paired crop, the /255 scale
and AWGN on x on a C++ thread pool behind a bounded prefetch queue
(``csrc/dataloader.cc``, a copy of the JAX package's source).

The library builds with ``g++`` on first use (the JAX Makefile's flags and
libraries: libpng and libjpeg) into
``torch_admm_deconv_tpu_torch/_build/runtime-<hash>/``, keyed on a hash of
the source and the flags, under a file lock, so concurrent processes build
it once. ``ensure_built`` raises ``RuntimeError`` with the compiler's output
when the build fails; nothing falls back to another loader.

Only one worker thread (``n_threads=1``) makes the batches a function of
the seed: each worker draws from its own generator and the workers race
for batches.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dataloader.cc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libtadruntime.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread")
LDLIBS = ("-lpng", "-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LDLIBS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"runtime-{digest.hexdigest()[:16]}" / LIB_NAME


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native loader builds with a C++17 compiler")
    return cxx


def ensure_built(force: bool = False) -> bool:
    """Build the shared library unless it is there (always with ``force``).
    Returns True; raises ``RuntimeError`` with the compiler's output when the
    build fails (missing compiler, libpng or libjpeg)."""
    path = lib_path()
    with _lock:
        if path.exists() and not force:
            return True
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path.parent / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if path.exists() and not force:
                return True
            tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
            cmd = [_compiler(), *CXX_FLAGS, "-shared", "-o", str(tmp), str(SOURCE), *LDLIBS]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"building the native loader failed ({' '.join(cmd)}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    ensure_built()
    lib = ctypes.CDLL(str(lib_path()))
    lib.tad_loader_create.restype = ctypes.c_void_p
    lib.tad_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.tad_loader_next.restype = ctypes.c_int
    lib.tad_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_float)]
    lib.tad_loader_batches_per_epoch.restype = ctypes.c_int
    lib.tad_loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.tad_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def is_available() -> bool:
    """Whether the library is built (``ensure_built`` builds it)."""
    return lib_path().exists()


class NativeDataLoader:
    """Drop-in for ``data.DataLoader`` backed by the C++ worker pool."""

    def __init__(
        self,
        x_paths: Sequence[str],
        y_paths: Sequence[str],
        batch_size: int,
        crop: Tuple[int, int],
        awgn_std_range: Tuple[int, int] = (0, 0),
        shuffle: bool = True,
        seed: int = 0,
        n_threads: int = 4,
        prefetch: int = 4,
    ):
        if len(x_paths) != len(y_paths) or len(x_paths) == 0:
            raise ValueError(f"need as many x as y paths, at least one: got {len(x_paths)} and "
                             f"{len(y_paths)}")
        lib = _load()
        self._lib = lib
        self.batch_size = batch_size
        self.crop = crop
        n = len(x_paths)
        xs = (ctypes.c_char_p * n)(*[str(p).encode() for p in x_paths])
        ys = (ctypes.c_char_p * n)(*[str(p).encode() for p in y_paths])
        self._handle = lib.tad_loader_create(
            xs,
            ys,
            n,
            batch_size,
            crop[0],
            crop[1],
            awgn_std_range[0],
            awgn_std_range[1],
            1 if shuffle else 0,
            seed,
            n_threads,
            prefetch,
        )
        if not self._handle:
            raise RuntimeError("tad_loader_create failed")
        self._batches = lib.tad_loader_batches_per_epoch(self._handle)

    @classmethod
    def from_dirs(cls, x_dir, y_dir, batch_size, crop, **kw) -> "NativeDataLoader":
        xs = sorted(str(p) for p in Path(x_dir).glob("*"))
        ys = sorted(str(p) for p in Path(y_dir).glob("*"))
        return cls(xs, ys, batch_size, crop, **kw)

    def __len__(self) -> int:
        return self._batches

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        shape = (self.batch_size, 3, self.crop[0], self.crop[1])
        x = np.empty(shape, np.float32)
        y = np.empty(shape, np.float32)
        rc = self._lib.tad_loader_next(
            self._handle,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            raise StopIteration
        return x, y

    def __iter__(self):
        for _ in range(self._batches):
            yield self.next_batch()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.tad_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
