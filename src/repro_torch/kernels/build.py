"""Build the CUDA kernels from this package's sources and load them.

``nvcc`` compiles ``csrc/gain.cu`` for ``sm_90a`` into a shared library with
a plain C interface, which ``ctypes`` loads (no PyTorch headers, so a build
takes seconds).  The build runs at first use, into ``_build/`` beside this
file (or ``REPRO_TORCH_BUILD_DIR``); the library's name carries a hash of
the source and flags, so an edited source is rebuilt and never mixed with
an old binary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("gain.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None


class Build(NamedTuple):
    path: Path
    seconds: Optional[float]   # nvcc wall time; None when already built
    log: str                   # nvcc's output (-Xptxas -v: registers, smem)


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               Path(__file__).resolve().parent / "_build"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build on a machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"libgain_{_digest()}.so"


def build(force: bool = False) -> Build:
    """Compile the kernels unless an up-to-date library exists."""
    out = library_path()
    if out.exists() and not force:
        return Build(out, None, "")
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return Build(out, time.perf_counter() - t0, proc.stderr + proc.stdout)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    lib.gain_matvec_launch.argtypes = [p, p, i, i, i, i, d, p, p, p]
    lib.gain_family_stats_launch.argtypes = [p, p, i, p, ll, p, ll, i, i, i,
                                             i, i, p, p]
    lib.megastep_launch.argtypes = [p, p, i, p, p, p, p, p, ll, p, ll, i, i,
                                    i, i, i, d, p, p, p, p, p]
    for fn in (lib.gain_matvec_launch, lib.gain_family_stats_launch,
               lib.megastep_launch):
        fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The bound kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = _bind(ctypes.CDLL(str(build().path)))
    return _LIB
