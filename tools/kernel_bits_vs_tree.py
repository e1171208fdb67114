#!/usr/bin/env python3
"""Hold this tree's kernels bitwise against another tree's on the routes
both have.

``--src`` names the ``src`` directory of another tree (an unpacked older
commit).  Its ``repro_torch/kernels/build.py`` builds that tree's CUDA
sources into that tree's ``_build`` directory; this tree's wrappers then
run every case twice, once on each library (switched by ``build.load``;
the C entries of the routes compared take the same arguments in both
trees), and the outputs must be equal bit for bit.  The cases are the main paths' routes
at ``chip_smoke``'s shapes: flash attention on both routes (the
reference's cases, Lk != Lq, head dim 96, the yi-6b slice), the SSD tile
on its three fixed-shape routes (dtx formed on load too), the state pass
on both, ``ssd_chunked``, the gain kernels at wide-192's and
``chip_smoke.FAMILY_TIMED``'s shapes in float32 and bf16, and
``gain_matvec`` / ``practical_gain`` at the kernel suite's one agent
(``chip_smoke.MATVEC_LONG[0]``) in float32 and float16; flash's float32
cases run ``flash_kernel`` (forced) on both trees.  Beside them, and
counted apart: ``flash_wide_kernel`` past head dim 256 (``wide_cases``)
and ``ssd_chunk_generic_kernel`` forced at ``chip_smoke``'s
``SSD_FIXED_VS_GENERIC`` and ``SSD_CONTRACT_TILES`` shapes
(``generic_cases``), both bitwise; and the float32 cases on this tree's
route (the tensor cores' float32 kind, ``flash_attention_wgmma_f32``)
against the other tree's ``flash_kernel`` on the same inputs
(``float32_cases``): not bitwise, each case's max abs distance listed.

A tree whose library has no ``gain_matvec_tiles_launch`` (before the
matvec took its T-tiles, one block an agent) runs its matvec cases
through that tree's C entry, ``gain_matvec_launch``, called as that
tree's wrapper called it (``legacy_matvec``).

Needs one GPU with sm_90a and nvcc.  Run from the repository root:

    python3 tools/kernel_bits_vs_tree.py --src DIR [--out FILE]

Prints the card's name and power limit, one JSON line per case
(``equal``: bitwise; ``group``) and a summary line; exits 1 if any case
but a ``float32_cases`` one differs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def other_library(src):
    """The other tree's kernel library, built by its own ``build.py``
    (loaded under another module name)."""
    path = os.path.join(src, "repro_torch", "kernels", "build.py")
    spec = importlib.util.spec_from_file_location("other_kernel_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build()


# gain_matvec_launch's arguments in a tree without the T-tiled entry:
# phi, g, dtype, agents, T, n, eps, vector, proj, gain, stream
_LEGACY_MATVEC = ("p", "p", "i", "i", "i", "i", "d", "i", "p", "p", "p")


def legacy_matvec(path, phi, g, eps, want_proj):
    """gain_matvec (``want_proj``) or practical_gain through the
    one-block-per-agent C entry of the library at ``path``, as its tree's
    wrapper launched it (same-dtype phi and g)."""
    import ctypes

    import torch

    from repro_torch.kernels import gain as K
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "d": ctypes.c_double}
    fn = ctypes.CDLL(str(path)).gain_matvec_launch
    fn.argtypes = [types[c] for c in _LEGACY_MATVEC]
    fn.restype = ctypes.c_int
    *batch, T, n = phi.shape
    agents = phi.numel() // max(T * n, 1)
    proj = gain = None
    if want_proj:
        proj = torch.empty(tuple(batch) + (T,), dtype=torch.float32,
                           device=phi.device)
    else:
        gain = torch.empty(tuple(batch), dtype=torch.float32,
                           device=phi.device)
    vec = K.matvec_vector_pass(n, phi.dtype, phi.data_ptr(), g.data_ptr())
    ptr = lambda t: None if t is None else t.data_ptr()
    code = fn(ptr(phi), ptr(g), K._DTYPES[phi.dtype], agents, T, n,
              float(eps), int(vec), ptr(proj), ptr(gain),
              torch.cuda.current_stream(phi.device).cuda_stream)
    if code:
        raise RuntimeError(f"gain_matvec_launch failed: CUDA error {code}")
    return proj if want_proj else gain


def cases(dev):
    """(label, fn, legacy) triples; fn() runs this tree's wrapper on fixed
    inputs, legacy(path) the same function through an older library's
    entry (None where the entries agree)."""
    import torch

    import chip_smoke as S
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ssd_scan as SS

    gen = torch.Generator().manual_seed(11)
    out = []
    flash = (S.FLASH_CASES + S.FLASH_D96_CASES + S.FLASH_CROSS_CASES
             + (S.FLASH_SLICE,))
    for c in flash:
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = S._flash_inputs(gen, dev, c, dt)
            r = FA.cuda_route(q, k, v)
            if r not in (FA.WGMMA, FA.WGMMA_F32):
                continue   # bf16 at d 16 and 32: the padded route
            kw = dict(causal=c["causal"], window=c["window"])
            if r is FA.WGMMA_F32:   # flash_kernel, the other tree's route
                out.append((f"flash {c} {dt} flash_kernel (forced)",
                            lambda q=q, k=k, v=v, kw=kw: FA.flash_attention(
                                q, k, v, force=FA.SIMT, **kw)))
                continue
            out.append((f"flash {c} {dt} {r.kernel}",
                        lambda q=q, k=k, v=v, kw=kw:
                        FA.flash_attention(q, k, v, **kw)))
    tiles = ((S.SSD_TILE_CASE, S.SSD_SLICE, S.JAMBA_SSD_SMALL)
             + S.SSD_TILE_SHAPES)
    for c in tiles:
        for dt in (torch.float32, torch.bfloat16):
            dtx, cum, bm, cm = S._ssd_inputs(gen, dev, c, dt)
            r = SS.cuda_route(dtx, cum, bm, cm)
            out.append((f"ssd tile {c} {dt} {r.kernel}",
                        lambda a=(dtx, cum, bm, cm): SS.ssd_chunk_tiles(*a)))
            if r != SS.SIMT:
                out.append((f"ssd tile {c} {dt} forced ssd_chunk_kernel",
                            lambda a=(dtx, cum, bm, cm):
                            SS.ssd_chunk_tiles(*a, force=SS.SIMT)))
                xh, dts = dtx.to(dt), dtx[..., 0].abs() * 0.1
                out.append((f"ssd tile {c} {dt} dtx on load",
                            lambda a=(xh, dts, cum, bm, cm):
                            SS.ssd_chunk_tiles_xdt(*a)))
    for c in (S.SSD_TILE_CASE, S.SSD_SLICE, S.JAMBA_SSD_SMALL):
        y_intra, states, cum, c32 = S._pass_inputs(gen, dev, c)
        L = c["nc"] * c["Q"] - 5
        for dt in (torch.float32, torch.bfloat16):
            a = (y_intra, states, cum, c32.to(dt), L, dt)
            r = SS.check_state_pass(*a)
            out.append((f"ssd pass {c} {dt} {r.kernel}",
                        lambda a=a: SS.ssd_state_pass(*a)))
            if r != SS.STATE_PASS_SIMT:
                out.append((f"ssd pass {c} {dt} forced ssd_state_pass_kernel",
                            lambda a=a: SS.ssd_state_pass(
                                *a, route=SS.STATE_PASS_SIMT)))
    for c in S.SSD_CHUNKED_WIDE[:1] + S.JAMBA_SSD_CHUNKED[:1]:
        for dt in (torch.float32, torch.bfloat16):
            a = S._chunked_inputs(gen, dev, c, dt)
            out.append((f"ssd_chunked {c} {dt}",
                        lambda a=a: SS.ssd_chunked(*a, chunk=128)))
    dgen = torch.Generator(device=dev).manual_seed(3)
    for label, shape, onehot in S.FAMILY_TIMED:
        inp = S.family_inputs(dev, dgen, shape, onehot)
        for dt in (torch.float32, torch.bfloat16):
            x = dict(inp, phi=inp["phi"].to(dt), g=inp["g"].to(dt))
            out.append((f"gain_matvec {label} {dt}",
                         lambda x=x: K.gain_matvec(x["phi"], x["g"]),
                         lambda path, x=x: legacy_matvec(
                             path, x["phi"], x["g"], 1.0, True)))
            out.append((f"practical_gain {label} {dt}",
                         lambda x=x: K.practical_gain(x["phi"], x["g"], 0.5),
                         lambda path, x=x: legacy_matvec(
                             path, x["phi"], x["g"], 0.5, False)))
            out.append((f"gain_family_stats {label} {dt}",
                        lambda x=x: K.gain_family_stats(
                            x["phi"], x["g"], x["gj"], x["pm"])))
            out.append((f"gain_family_stats 2-col {label} {dt}",
                        lambda x=x: K.gain_family_stats(x["phi"], x["g"])))
            out.append((f"megastep {label} {dt}",
                        lambda x=x: K.megastep_call(
                            x["phi"], x["g"], x["w"], x["ctl"], x["arand"],
                            x["gj"], x["pm"], eps=0.5)))
    T, n = S.MATVEC_LONG[0]
    for dt in (torch.float32, torch.float16):
        phi = torch.randn(T, n, generator=dgen, device=dev).to(dt)
        g = torch.randn(n, generator=dgen, device=dev).to(dt)
        out.append((f"gain_matvec kernel suite {T}x{n} {dt}",
                    lambda phi=phi, g=g: K.gain_matvec(phi, g),
                    lambda path, phi=phi, g=g: legacy_matvec(
                        path, phi, g, 1.0, True)))
        out.append((f"practical_gain kernel suite {T}x{n} {dt}",
                    lambda phi=phi, g=g: K.practical_gain(phi, g, 0.5),
                    lambda path, phi=phi, g=g: legacy_matvec(
                        path, phi, g, 0.5, False)))
    return [c if len(c) == 3 else c + (None,) for c in out]


def wide_cases(dev):
    """(label, fn, None) triples of ``flash_wide_kernel`` (head dims past
    256, which no main path runs): d 320 and 512 in float32, bf16 and
    float16 under ``chip_smoke.FLASH_CONTRACT_MASKS``, and 16-bit inputs off
    16-byte boundaries.  Counted apart from the main paths' cases."""
    import torch

    import chip_smoke as S
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator().manual_seed(13)
    grid = [(D, dt, m, 0) for D in (320, 512)
            for dt in (torch.float32, torch.bfloat16, torch.float16)
            for m in S.FLASH_CONTRACT_MASKS]
    grid += [(320, torch.bfloat16, S.FLASH_CONTRACT_MASKS[0], 1),
             (512, torch.float16, S.FLASH_CONTRACT_MASKS[2], 3)]
    out = []
    for D, dt, m, offset in grid:
        c = dict(B=1, H=4, KVH=2, D=D, **m)
        q, k, v = (S._offset_copy(x, offset)
                   for x in S._flash_inputs(gen, dev, c, dt))
        assert FA.cuda_route(q, k, v) is FA.WIDE
        kw = dict(causal=c["causal"], window=c["window"])
        out.append((f"flash wide {c} {dt} offset {offset}",
                    lambda q=q, k=k, v=v, kw=kw:
                    FA.flash_attention(q, k, v, **kw), None))
    return out


def generic_cases(dev):
    """(label, fn, None) triples of ``ssd_chunk_generic_kernel`` forced at
    ``chip_smoke.SSD_FIXED_VS_GENERIC``'s shapes and at
    ``SSD_CONTRACT_TILES`` in float32, bf16 and float16 B/C (1 x 2 chunks,
    3 heads), which no main path runs.  Counted apart."""
    import torch

    import chip_smoke as S
    from repro_torch.kernels import ssd_scan as SS

    gen = torch.Generator().manual_seed(17)
    shapes = [(label, c, d) for label, c, d in S.SSD_FIXED_VS_GENERIC]
    shapes += [(f"contract {Q}x{N}x{P}", dict(B=1, nc=2, Q=Q, H=3, P=P, N=N),
                d) for Q, N, P in S.SSD_CONTRACT_TILES
               for d in ("float32", "bfloat16", "float16")]
    out = []
    for label, c, d in shapes:
        a = S._ssd_inputs(gen, dev, c, getattr(torch, d))
        out.append((f"ssd generic tile {label} {c} {d}",
                    lambda a=a: SS.ssd_chunk_tiles(*a, force=SS.GENERIC),
                    None))
    return out


def float32_cases(dev):
    """(label, fn, other) triples of flash's float32 cases (the reference's,
    head dim 96, Lk != Lq, the yi-6b slice): ``fn`` runs this tree's route
    (the tensor cores' float32 kind), ``other`` flash_kernel forced, run on
    the other tree's library.  Not bitwise: the distances are listed."""
    import torch

    import chip_smoke as S
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator().manual_seed(11)
    out = []
    for c in (S.FLASH_CASES + S.FLASH_D96_CASES + S.FLASH_CROSS_CASES
              + (S.FLASH_SLICE,)):
        q, k, v = S._flash_inputs(gen, dev, c, torch.float32)
        kw = dict(causal=c["causal"], window=c["window"])
        r = FA.cuda_route(q, k, v)
        out.append((f"flash {c} float32 {r.counter} vs flash_kernel",
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention(q, k, v,
                                                                    **kw),
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention(
                        q, k, v, force=FA.SIMT, **kw)))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import torch

    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    this = build.build().path
    other = other_library(os.path.abspath(args.src)).path
    print(json.dumps({"other_src": os.path.abspath(args.src),
                      "other_library": str(other),
                      "this_library": str(this)}), flush=True)
    groups = (("main", cases(dev)), ("wide", wide_cases(dev)),
              ("generic", generic_cases(dev)),
              ("float32", float32_cases(dev)))
    rows = []
    for group, triples in groups:
        for label, fn, other_fn in triples:
            build.load(this)
            a = fn()
            tiled = hasattr(build.load(other), "gain_matvec_tiles_launch")
            if group == "float32":
                b = other_fn()
            else:
                b = fn() if other_fn is None or tiled else other_fn(other)
            build.load(this)
            a = a if isinstance(a, tuple) else (a,)
            b = b if isinstance(b, tuple) else (b,)
            equal = all(torch.equal(x, y) for x, y in zip(a, b))
            row = {"group": group, "case": label, "equal": equal}
            if group == "float32":
                row["max_abs_vs_other"] = max(float((x.double() - y).abs().max())
                                              for x, y in zip(a, b))
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {"card": card}
    for group, _ in groups:
        mine = [r for r in rows if r["group"] == group]
        key = "cases" if group == "main" else f"{group}_cases"
        summary[key] = len(mine)
        summary[key.replace("cases", "differ")] = sum(not r["equal"]
                                                      for r in mine)
    summary["float32_max_abs_vs_other"] = max(
        (r["max_abs_vs_other"] for r in rows if r["group"] == "float32"),
        default=0.0)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)
    return 1 if any(not r["equal"] for r in rows
                    if r["group"] != "float32") else 0


if __name__ == "__main__":
    sys.exit(main())
