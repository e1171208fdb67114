"""Build the CUDA kernels from this package's sources and load them.

``nvcc`` compiles every source in ``csrc/`` (``SOURCES``) for ``sm_90a``:
one ``nvcc -c`` per source, all started together, then one ``nvcc
-shared`` link of the objects into one shared library with a plain C
interface, which ``ctypes`` loads (no PyTorch headers, so a build takes
seconds).  The build runs at first use, into ``_build/`` beside this file
(or ``REPRO_TORCH_BUILD_DIR``); the library's name carries a hash of every
source and the flags, so an edited source is rebuilt and never mixed with
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
SOURCES = ("gain.cu", "ssd_scan.cu", "ssd_generic.cu", "flash_attention.cu",
           "flash_contract.cu", "flash_loaded.cu", "flash_f32.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
_LIBS: dict = {}   # bound libraries by path


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
    for path in [CSRC / name for name in SOURCES] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"librepro_torch_kernels_{_digest()}.so"


def build(force: bool = False) -> Build:
    """Compile the kernels unless an up-to-date library exists."""
    out = library_path()
    if out.exists() and not force:
        return Build(out, None, "")
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [os.path.join(tmp, f"{Path(s).stem}.o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(CSRC / src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, log) for s, p, log
                  in zip(SOURCES, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{s} ({rc}):\n{log}" for s, rc, log in failed))
        lib = os.path.join(tmp, out.name)
        link = subprocess.run([nvcc, "-shared", "-Xcompiler", "-fPIC", "-o",
                               lib, *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(lib, out)
    return Build(out, time.perf_counter() - t0, "".join(logs))


def _signatures() -> dict:
    """Every C entry's argument types; each returns an int (a cudaError_t
    or a count)."""
    p, i, ll, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
    return {
        "gain_matvec_tiles_launch": [p, p, i, i, i, i, d, i, i, i, p, p, p,
                                     p],
        "gain_family_stats_launch": [p, p, i, i, p, ll, p, ll, i, i, i, i, i,
                                     i, i, i, i, p, p, p],
        "megastep_launch": [p, p, i, i, p, p, p, p, p, ll, p, ll, i, i, i, i,
                            i, i, i, i, i, p, d, p, p, p, p, p],
        "ssd_chunk_launch": [p, p, p, p, i, i, i, i, i, i, p, p, p],
        "ssd_chunk_wgmma_launch": [p, p, p, p, i, i, i, i, i, i, p, p, p],
        "ssd_chunk_wgmma_xdt_launch": [p, p, p, p, p, i, i, i, i, i, i, p, p,
                                       p],
        "ssd_chunk_generic_launch": [p, p, p, p, i, i, i, i, i, i, p, p, p],
        "ssd_chunk_wgmma_smem_bytes": [i, i, i, i],
        "ssd_state_pass_launch": [p, p, p, p, i, i, i, i, i, i, i, i, i, p, p,
                                  p],
        "ssd_state_pass_smem_bytes": [i, i, i],
        "ssd_state_pass_wgmma_launch": [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                        p, p, p],
        "ssd_state_pass_wgmma_smem_bytes": [i, i, i],
        "ssd_state_pass_generic_launch": [p, p, p, p, i, i, i, i, i, i, i, i,
                                          i, p, p, p],
        "ssd_blocks_per_sm": [i, i],
        "flash_attention_launch": [p, p, p, i, i, i, i, i, i, i, i, i, p, p],
        "flash_attention_wgmma_launch": [p, p, p, i, i, i, i, i, i, i, i, p,
                                         p],
        "flash_attention_wgmma_f16_launch": [p, p, p, i, i, i, i, i, i, i,
                                             i, p, p],
        "flash_attention_wgmma_smem_bytes": [i],
        "flash_attention_wgmma_blocks_per_sm": [i],
        "flash_wgmma_contract_blocks_per_sm": [i, i],
        "flash_attention_wgmma_loaded_launch": [i, p, p, p, i, i, i, i, i, i,
                                                i, i, p, p],
        "flash_wgmma_loaded_blocks_per_sm": [i, i],
        "flash_attention_wgmma_f32_launch": [p, p, p, i, i, i, i, i, i, i, i,
                                             p, p],
        "flash_wgmma_f32_smem_bytes": [i],
        "flash_wgmma_f32_blocks_per_sm": [i],
    }


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type every C entry ``lib`` has.  A library built from an older tree
    may lack the newer entries: a wrapper that calls one raises
    AttributeError there."""
    for name, argtypes in _signatures().items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def load(path: Optional[Path] = None) -> ctypes.CDLL:
    """The bound kernel library that every wrapper launches: this package's,
    built on first use.  With ``path``, the library at ``path`` (one built
    from another tree's sources whose C entries take the same arguments)
    is bound and launched from then on, until ``load`` is given another
    path; ``load(build().path)`` goes back to this package's."""
    global _LIB
    if path is not None:
        key = str(Path(path).resolve())
        if key not in _LIBS:
            _LIBS[key] = _bind(ctypes.CDLL(key))
        _LIB = _LIBS[key]
    elif _LIB is None:
        _LIB = load(build().path)
    return _LIB
