#!/usr/bin/env python3
"""Copies of the flash tensor-core kernel with one part changed, built
beside the package's and run on the same inputs.

A copy (``COPIES``) is ``csrc/`` in a temporary directory with exact
substitutions in ``csrc/flash_wgmma.cuh`` (each must match once; the script
stops and names the copy if the source moved), linked from the sources the
copy names.  This table is the one place that patches the kernel's source.
Two modes read the copies:

``single-p``: can chip_smoke's checks of ``flash_wgmma_kernel`` see the
P_lo half of P?  The kernel multiplies P by V as a hi/lo pair of bf16 (O +=
P_hi V + P_lo V), which keeps P to about 16 bits at 1.5x the tensor-core
products of a single bf16 P.  The ``single_p`` copy drops bf16's P_lo
product (a single bf16 P, as FA2 and FA3 do).  It and the package's kernel
are held against the reference computed in float32 on the same bf16 inputs,
under both of chip_smoke.py's checks of the tensor-core route: ``bf16_ulps``
(limit ``FLASH_ULP_LIMIT``) and the scale-normalized error of ``FLASH_TOL``
(of |want| + 1).  Cases: the bf16 reference cases at head dims 64 and 128
and yi-6b's prefill slice.  Prints one JSON object per case; exits 1 if the
package's kernel fails either check or the copy passes the ulp check.

``loaded``: where the time of the loaded route (``flash_wgmma_kernel<E, W,
true>``, ``csrc/flash_loaded.cu``: a producer warpgroup of its own in
place of TMA, for 16-bit inputs off 16-byte boundaries or at head dims that
are not multiples of 8) goes.  Copies whose output is wrong (only the time
is read), timed beside the package's route and TMA's route on the same
values on 16-byte boundaries, at the smoke's slices:

- ``package``: the package's loaded route;
- ``no_shift``: the producer loads but stores nothing (the consumers'
  arithmetic and the barriers alone);
- ``producer_alone``: the consumers skip every tile's arithmetic (the
  producer's loads, shifts and stores alone);
- ``one_pv``: width 256's P V as one 256-column product in place of four
  64-column ones (the same bits);
- ``tma_min_blocks_1``: TMA's route (``flash_attention.cu``) built with a
  minimum of one block an SM in its launch bounds, beside the package's TMA
  route (``tma``), at bf16's main-path widths.

``f32``: where the time of the float32 kind (``flash_wgmma_kernel<float,
W, true>``, ``csrc/flash_f32.cu``: three bf16 pieces of every float32
operand, split by the producer warpgroup) goes, and the choice of its kv
tile.  Timed beside the package's kind and ``flash_kernel`` (forced) at
the float32 slices of yi-6b, phi3-mini (d 96) and phi-2 (d 80):

- ``package``: the package's float32 kind (32-key tiles, two stages at
  width 128);
- ``f32_kv64``: 64-key tiles (one stage at width 128, two at 64; its
  output is right, not the same bits);
- ``f32_consumers_alone``: the producer loads and splits but stores nothing
  (the consumers' arithmetic and the barriers alone);
- ``f32_producer_alone``: the consumers skip every tile's arithmetic (the
  producer's loads, splits and stores alone).

It also prints each copy's ptxas registers and spills for the kernel.
Prints the card's name and power limit and one JSON object per slice.

Needs one GPU with sm_90a and nvcc.  Run from the repository root:

    python3 tools/flash_copies.py single-p
    python3 tools/flash_copies.py loaded
    python3 tools/flash_copies.py f32
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import chip_smoke as S  # noqa: E402

# name: (sources linked, substitutions in flash_wgmma.cuh)
COPIES = {
    # bf16's P_lo product (float16 keeps its own, a tile's P V apart)
    "single_p": (("flash_attention.cu", "flash_contract.cu"), (
        ("            mma_rs_t<E, W>(acc, p_lo[kk], bv, 1);\n", ""),)),
    "no_shift": (("flash_loaded.cu",), (
        ("        if (in_atoms) {\n", "        if (in_atoms && kPer < 0) {\n"),)),
    "producer_alone": (("flash_loaded.cu",), (
        ("      mbar_wait(bar_full(st), (t / kNS) & 1);\n",
         "      mbar_wait(bar_full(st), (t / kNS) & 1);\n"
         "      if constexpr (kLoaded) {\n"
         "        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(bar_empty(st));\n"
         "        continue;\n"
         "      }\n"),)),
    # width 256's P V as one 256-column product, as TMA's route runs it
    "one_pv": (("flash_loaded.cu",), (
        ("        } else if constexpr (kLoaded && W == 4 * kAtom) {\n",
         "        } else if constexpr (kLoaded && W < 0) {\n"),)),
    "tma_min_blocks_1": (("flash_attention.cu", "flash_contract.cu"), (
        ("__global__ void __launch_bounds__(kLoaded ? kThreadsLoaded : "
         "kThreadsWg)",
         "__global__ void __launch_bounds__(kLoaded ? kThreadsLoaded : "
         "kThreadsWg, 1)"),)),
    # the float32 kind's kv tile, and its two sides alone
    "f32_kv64": (("flash_f32.cu",), (
        ("constexpr int kF32BlockN = 32;", "constexpr int kF32BlockN = 64;"),)),
    "f32_consumers_alone": (("flash_f32.cu",), (
        ("        if (read) {\n", "        if (read && kPer < 0) {\n"),)),
    "f32_producer_alone": (("flash_f32.cu",), (
        ("      mbar_wait(bar_full(st), (t / kNS) & 1);\n",
         "      mbar_wait(bar_full(st), (t / kNS) & 1);\n"
         "      if constexpr (kLoaded) {\n"
         "        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(bar_empty(st));\n"
         "        continue;\n"
         "      }\n"),)),
}
LOADED_COPIES = ("no_shift", "producer_alone", "one_pv", "tma_min_blocks_1")
F32_COPIES = ("f32_kv64", "f32_consumers_alone", "f32_producer_alone")
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {  # C entry: argument types
    "flash_attention_wgmma_launch": [_P, _P, _P] + [_I] * 8 + [_P, _P],
    "flash_attention_wgmma_loaded_launch": [_I, _P, _P, _P] + [_I] * 8
                                           + [_P, _P],
    "flash_attention_wgmma_f32_launch": [_P, _P, _P] + [_I] * 8 + [_P, _P],
}
# (label, shape, dtype, element offset of q, k and v from a 16-byte boundary)
LOADED_SLICES = (
    ("yi-6b float16 unaligned", dict(S.FLASH_SLICE), "float16", 1),
    ("gemma-7b d256 unaligned", dict(B=1, L=8192, H=16, KVH=16, D=256,
                                     causal=True, window=0), "bfloat16", 1),
    ("d100", dict(B=1, L=2048, H=32, KVH=32, D=100, causal=True, window=0),
     "bfloat16", 0),
    ("yi-6b bf16", dict(S.FLASH_SLICE), "bfloat16", 0),
    ("phi3 d96 bf16", dict(S.FLASH_SLICE_D96), "bfloat16", 0))


def build_copies(tmp, names):
    """{name: (library, ptxas lines)} of each copy, built in parallel."""
    from repro_torch.kernels import build
    procs = {}
    for name in names:
        sources, subs = COPIES[name]
        d = os.path.join(tmp, name)
        shutil.copytree(build.CSRC, d)
        path = os.path.join(d, "flash_wgmma.cuh")
        with open(path) as f:
            src = f.read()
        for a, b in subs:
            if src.count(a) != 1:
                raise SystemExit(f"flash_wgmma.cuh: {name}'s substitution "
                                 "no longer matches once; update COPIES")
            src = src.replace(a, b)
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-o", lib,
             *(os.path.join(d, s) for s in sources)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-3000:]}")
        dll = ctypes.CDLL(lib)
        for entry, args in ENTRIES.items():
            fn = getattr(dll, entry, None)
            if fn is not None:
                fn.argtypes, fn.restype = args, _I
        out[name] = (dll, ptxas_lines(log))
    return out


def ptxas_lines(log):
    """Registers and spills of each flash_wgmma_kernel instantiation."""
    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "flash_wgmma_kernel" in line:
            name = line.split("'")[1]
            used = " ".join(x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4]
                            if "Used" in x or "spill" in x)
            out.append(f"{name[name.index('flash_wgmma_kernel'):][:60]} {used}")
    return out


def single_p(dev, tmp):
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import check, stream

    dll = build_copies(tmp, ("single_p",))["single_p"][0]
    gen = torch.Generator().manual_seed(3)
    ok = True
    for c in S.FLASH_CASES + (S.FLASH_SLICE,):
        if c["D"] not in FA.WGMMA_HEAD_DIMS:
            continue
        q, k, v = S._flash_inputs(gen, dev, c, torch.bfloat16)
        kw = dict(causal=c["causal"], window=c["window"])
        want32 = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        package = FA.flash_attention(q, k, v, **kw)
        single = torch.empty_like(q)
        B, L, H, D = q.shape
        check(dll.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, L, H, k.shape[2], D,
            int(c["causal"]), int(c["window"]), single.data_ptr(), stream(q)),
            "flash_attention (single bf16 P)")
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


def loaded(dev, tmp):
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.common import check, stream

    S.emit({"copy": "package", "ptxas": ptxas_lines(build.build(force=True).log)})
    copies = build_copies(tmp, LOADED_COPIES)
    for name, (_, ptxas) in copies.items():
        S.emit({"copy": name, "ptxas": ptxas})
    gen = torch.Generator().manual_seed(5)
    for label, c, dt, offset in LOADED_SLICES:
        dtype = getattr(torch, dt)
        x = [t.to(dtype) for t in S._flash_inputs(gen, dev, c, torch.float32)]
        q, k, v = (S._offset_copy(t, offset) for t in x)
        kw = dict(causal=c["causal"], window=c["window"])
        B, L, H, D = q.shape
        route = FA.cuda_route(q, k, v)
        row = {"slice": label, "shape": c, "dtype": dt, "offset": offset,
               "route": route.counter}
        row["package"] = S.time_ms(lambda: FA.flash_attention(q, k, v, **kw))
        if D % 8 == 0:
            row["tma"] = S.time_ms(lambda: FA.flash_attention(*x, **kw))
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, L, H,
                k.shape[2], D, int(kw["causal"]), int(kw["window"]),
                o.data_ptr(), stream(q))
        for name, (dll, _) in copies.items():
            if route is FA.WGMMA_LOADED:
                fn = getattr(dll, "flash_attention_wgmma_loaded_launch", None)
                pre = ({torch.bfloat16: 1, torch.float16: 2}[dtype],)
            else:
                fn = getattr(dll, "flash_attention_wgmma_launch", None)
                pre = ()
            if fn is not None:
                row[name] = S.time_ms(
                    lambda fn=fn, pre=pre, name=name: check(fn(*pre, *args), name))
        S.emit(row)
        del q, k, v, x, o
        S.empty_cache(dev)
    return 0


# (label, shape) of the float32 kind's slices
F32_SLICES = (("yi-6b float32", dict(S.FLASH_SLICE)),
              ("phi3 d96 float32", dict(S.FLASH_SLICE_D96)),
              ("phi-2 d80 float32", dict(B=1, L=2048, H=32, KVH=32, D=80,
                                         causal=True, window=0)))


def f32(dev, tmp):
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.common import check, stream

    S.emit({"copy": "package", "ptxas": ptxas_lines(build.build(force=True).log)})
    copies = build_copies(tmp, F32_COPIES)
    for name, (_, ptxas) in copies.items():
        S.emit({"copy": name, "ptxas": ptxas})
    gen = torch.Generator().manual_seed(6)
    for label, c in F32_SLICES:
        q, k, v = S._flash_inputs(gen, dev, c, torch.float32)
        kw = dict(causal=c["causal"], window=c["window"])
        B, L, H, D = q.shape
        if FA.cuda_route(q, k, v) is not FA.WGMMA_F32:
            raise SystemExit(f"{label}: not the float32 kind's route")
        row = {"slice": label, "shape": c}
        run = lambda: FA.flash_attention(q, k, v, **kw)  # noqa: E731
        row["package"] = S.time_ms(run)
        row["flash_kernel"] = S.time_ms(
            lambda: FA.flash_attention(q, k, v, force=FA.SIMT, **kw), reps=5)
        want = run()
        o = torch.empty_like(q)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, L, L, H,
                k.shape[2], D, int(kw["causal"]), int(kw["window"]),
                o.data_ptr(), stream(q))
        for name, (dll, _) in copies.items():
            fn = dll.flash_attention_wgmma_f32_launch
            row[name] = S.time_ms(lambda fn=fn, name=name: check(fn(*args), name))
            # f32_kv64: a right output, not the same bits
            row[name + "_max_abs_vs_package"] = float((o - want).abs().max())
        row["package_again"] = S.time_ms(run)
        S.emit(row)
        del q, k, v, o, want
        S.empty_cache(dev)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("single-p", "loaded", "f32"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    dev = torch.device("cuda", 0)
    S.device_line()
    modes = {"single-p": single_p, "loaded": loaded, "f32": f32}
    with tempfile.TemporaryDirectory() as tmp:
        return modes[args.mode](dev, tmp)


if __name__ == "__main__":
    sys.exit(main())
