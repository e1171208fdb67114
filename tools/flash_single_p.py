#!/usr/bin/env python3
"""Can chip_smoke's checks of flash_wgmma_kernel see the P_lo half of P?

``flash_wgmma_kernel`` multiplies P by V as a hi/lo pair of bf16 (O +=
P_hi V + P_lo V), which keeps P to about 16 bits at 1.5x the tensor-core
products of a single bf16 P.  This script builds a copy of
``csrc/flash_attention.cu`` and ``csrc/flash_contract.cu`` whose
``csrc/flash_wgmma.cuh`` drops bf16's P_lo product (a single bf16 P, as
FA2 and FA3 do) into a temporary directory, and holds that
variant and the package's kernel against the reference computed in float32
on the same bf16 inputs, under both of chip_smoke.py's checks of the
tensor-core route: ``bf16_ulps`` (limit ``FLASH_ULP_LIMIT``) and the
scale-normalized error of ``FLASH_TOL`` (of |want| + 1).  Cases: the bf16
reference cases at head dims 64 and 128 and yi-6b's prefill slice.

Needs one GPU with sm_90a and nvcc.  Run from the repository root:

    python3 tools/flash_single_p.py

Prints one JSON object per case; exits 1 if the package's kernel fails
either check or the variant passes the ulp check.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import chip_smoke as S  # noqa: E402

# bf16's P_lo product (float16 keeps its own, a tile's P V apart)
P_LO_PRODUCT = "        mma_rs_t<E, W>(acc, p_lo[kk], bv, 1);\n"


def build_single_p(tmp):
    """The tensor-core kernel with its P_lo product removed, as a library."""
    import shutil

    from repro_torch.kernels import build
    src = (build.CSRC / "flash_wgmma.cuh").read_text()
    if src.count(P_LO_PRODUCT) != 1:
        raise SystemExit("flash_wgmma.cuh: the P_lo product line moved; "
                         "update P_LO_PRODUCT")
    with open(os.path.join(tmp, "flash_wgmma.cuh"), "w") as f:
        f.write(src.replace(P_LO_PRODUCT, ""))
    # the copy of flash_attention.cu includes the edited header beside it
    # first, hopper.cuh and flash_simt.cuh from the package's csrc/
    cu = os.path.join(tmp, "flash_attention.cu")
    shutil.copy(build.CSRC / "flash_attention.cu", cu)
    lib = os.path.join(tmp, "libflash_single_p.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                    str(build.CSRC), "-shared", "-o", lib, cu,
                    str(build.CSRC / "flash_contract.cu")], check=True,
                   capture_output=True, text=True)
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.flash_attention_wgmma_launch.argtypes = [p, p, p, i, i, i, i, i, i,
                                                 i, i, p, p]
    dll.flash_attention_wgmma_launch.restype = i
    return dll


def main():
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import check, stream

    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    dev = torch.device("cuda", 0)
    S.device_line()
    gen = torch.Generator().manual_seed(3)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        dll = build_single_p(tmp)
        for c in S.FLASH_CASES + (S.FLASH_SLICE,):
            if c["D"] not in FA.WGMMA_HEAD_DIMS:
                continue
            q, k, v = S._flash_inputs(gen, dev, c, torch.bfloat16)
            kw = dict(causal=c["causal"], window=c["window"])
            want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                             **kw)
            package = FA.flash_attention(q, k, v, **kw)
            single = torch.empty_like(q)
            B, L, H, D = q.shape
            check(dll.flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, L, H,
                k.shape[2], D, int(c["causal"]), int(c["window"]), single.data_ptr(),
                stream(q)), "flash_attention (single bf16 P)")
            row = {"case": c}
            for name, got in (("hi_lo_p", package), ("single_bf16_p", single)):
                rel, ab = S.rel_err(got, want32)
                row[name] = dict(bf16_ulps=S.bf16_ulps(got, want32),
                                 flash_tol_err=rel, max_abs_err=ab)
            ok &= (row["hi_lo_p"]["bf16_ulps"] <= S.FLASH_ULP_LIMIT
                   and row["hi_lo_p"]["flash_tol_err"] <= S.FLASH_TOL["bfloat16"]
                   and row["single_bf16_p"]["bf16_ulps"] > S.FLASH_ULP_LIMIT)
            S.emit(row)
            del q, k, v, want32, package, single
            S.empty_cache(dev)
    S.emit({"ulp_limit": S.FLASH_ULP_LIMIT,
            "flash_tol": S.FLASH_TOL["bfloat16"], "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
