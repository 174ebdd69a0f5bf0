"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. All sources
build in parallel (one ``nvcc`` each) on first use, into
``torch_admm_deconv_tpu_torch/_build/<hash>/``, keyed on a hash of the sources
and flags, so a fresh checkout builds everything the first time a kernel is
launched and reuses the libraries afterwards.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class LaunchCounter:
    """Counts a wrapper's kernel launches (one per launch, nowhere else)."""

    def __init__(self) -> None:
        self.n = 0

    def add(self) -> None:
        self.n += 1

    def reset(self) -> None:
        self.n = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def build_dir() -> Path:
    """The directory for this set of sources and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_ROOT / digest.hexdigest()[:16]


class _Libraries:
    """The built libraries of this process, built once and loaded on demand."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loaded: dict[str, ctypes.CDLL] = {}
        self.build_seconds: float | None = None
        self.ptxas_log = ""

    def build(self) -> Path:
        """Compile every source whose library is missing, all at once."""
        out = build_dir()
        todo = [src for src in _sources() if not (out / f"lib{src.stem}.so").exists()]
        if not todo:
            return out
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        start = time.perf_counter()
        procs = []
        for src in todo:
            tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failures = []
        logs = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            logs.append(f"== {src.name}\n{log}")
            if proc.returncode != 0:
                failures.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, out / f"lib{src.stem}.so")
        self.build_seconds = time.perf_counter() - start
        self.ptxas_log = "\n".join(logs)
        if failures:
            raise RuntimeError("nvcc failed for " + "\n".join(failures))
        return out

    def load(self, name: str) -> ctypes.CDLL:
        """The library built from ``csrc/<name>.cu``."""
        with self._lock:
            lib = self._loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(self.build() / f"lib{name}.so"))
                self._loaded[name] = lib
            return lib


LIBRARIES = _Libraries()

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_kernels(log: str) -> list[dict]:
    """Registers and spills of each kernel in an ``nvcc -Xptxas -v`` log:
    ``[{"kernel", "registers", "spill_stores", "spill_loads"}]``, names
    demangled with ``cu++filt`` where the toolkit has it."""
    kernels, current = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = {"kernel": m.group(1), "registers": None, "spill_stores": 0, "spill_loads": 0}
            kernels.append(current)
        elif current is not None and (m := _SPILL.search(line)):
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif current is not None and (m := _REGS.search(line)):
            current["registers"] = int(m.group(1))
    for k, name in zip(kernels, demangle([k["kernel"] for k in kernels])):
        k["kernel"] = name
    return kernels


def demangle(names: list[str]) -> list[str]:
    """C++ names of mangled kernel symbols, by the toolkit's ``cu++filt``
    (the names as given where it is missing)."""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not names or not os.path.exists(filt):
        return names
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True).stdout
    lines = out.splitlines()
    return lines if len(lines) == len(names) else names


def check(status: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
