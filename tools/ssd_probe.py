#!/usr/bin/env python3
"""Where the SSD kernels' accuracy and time go, on the card.

Two probes of ``csrc/ssd_scan.cu`` at ``chip_smoke``'s shapes:

- accuracy: the tensor-core tiles (``ssd_chunk_wgmma_kernel`` and, at N
  16, ``ssd_chunk_wgmma_n16_kernel``, through ``ssd_chunk_tiles``) and the
  plain float32 version (``ref.ssd_chunk_ref``), each against a float64
  reference on the same inputs, at ``SSD_SLICE``, ``SSD_TILE_SHAPES``,
  ``JAMBA_SSD_SMALL`` and ``JAMBA_SSD_SLICE`` with float32 and bf16 B/C, as
  max |got - want| / (|want| + 1), the measure of ``SSD_TILE_TOL``;
- time: copies of the source with parts of a kernel removed, built into a
  temporary directory, timed by ``chip_smoke.time_ms`` at ``SSD_SLICE``
  (bf16): the tile as the main path calls it (dt x formed on load) whole,
  without its products, without the y products, without the state
  products and without its stores; the N 16 tile at ``JAMBA_SSD_SLICE``
  (dt x on load, and on float32 dtx as ``chip_smoke`` times it) whole,
  without its products and without its stores, and a copy that keeps G in
  registers at one block an SM (``kN16Blocks = 1``, held against the plain
  version), with each copy's registers and spills of the N 16 kernel from
  ``ptxas``; the CUDA-core state pass whole and
  without C . h; the tensor-core state pass whole, without its products,
  without its y stores, without its state loads, and without any input
  load (states, y_intra, C).  A copy's output is wrong by design; only its
  time is read.  The copies build in parallel.

Needs one GPU with sm_90a and nvcc.  Run from the repository root:

    python3 tools/ssd_probe.py

Prints the card's name and power limit, then one JSON object per case or
copy; exits 1 if the tile is farther from the float64 reference than
``SSD_TILE_TOL`` in any case.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import chip_smoke as S  # noqa: E402

Y_PRODUCTS = ("                  mma_rs<64>(y_cross, frag, bx, 1);\n",
              "                  mma_rs<64>(y_main, frag, bx, 1);\n")
STATE_PRODUCTS = "            mma_ss_mn<P>(\n"
Y_STORE = ("          *reinterpret_cast<float2*>(y + ((bc * Q + i) * H + h) "
           "* P + p) =\n")
STATE_STORE = "        *reinterpret_cast<float2*>(st + n * P + p) =\n"
PASS_PRODUCT = "    for (int n = 0; n < N; n += 4) {\n"
TC_PRODUCTS = ("            mma_ss_n32(acc_cross, da, db, 1);\n",
               "            mma_ss_n32(acc_main, da, db, 1);\n")
TC_Y_STORE = "      store2(yc + ((e & 2) ? 8 * HP : 0) + 8 * (e / 4),\n"
TC_STATE_LOAD = ("      for (int k = 0; k < 8; ++k) sn[j][k] = "
                 "__ldg(row + k * P);\n")
N16_BLOCKS = "constexpr int kN16Blocks = 2;\n"
TC_INPUT_LOADS = [
    (TC_STATE_LOAD, "      for (int k = 0; k < 8; ++k) sn[j][k] = k + v;\n"),
    ("      cp_async8(base + lay.yi + ((e / 2) * kThr + tid) * 8,\n",
     "      if (H < 0) cp_async8(base + lay.yi + ((e / 2) * kThr + tid) * 8,\n"),
    ("        cp_async16(base + s * lay.c_tile + off, src + g);\n",
     "        if (H < 0) cp_async16(base + s * lay.c_tile + off, src + g);\n")]

# each copy: (what it removes, [(line, replacement)])
COPIES = {
    "whole": [],
    "no_products": [(line, "                  ;\n") for line in Y_PRODUCTS]
    + [(STATE_PRODUCTS, "            if (0) mma_ss_mn<P>(\n")],
    "no_y_products": [(line, "                  ;\n") for line in Y_PRODUCTS],
    "no_state_products": [(STATE_PRODUCTS,
                           "            if (0) mma_ss_mn<P>(\n")],
    "no_stores": [(Y_STORE, "          if (H < 0)" + Y_STORE[9:]),
                  (STATE_STORE, "        if (H < 0)" + STATE_STORE[7:])],
    "pass_no_c_h": [(PASS_PRODUCT, "    for (int n = 0; n < 0; n += 4) {\n")],
    "tc_pass_no_products": [(line, "            ;\n") for line in TC_PRODUCTS],
    "tc_pass_no_y_stores": [(TC_Y_STORE, "      if (H < 0)" + TC_Y_STORE[5:])],
    "tc_pass_no_state_loads": TC_INPUT_LOADS[:1],
    "tc_pass_no_input_loads": TC_INPUT_LOADS,
    "n16_one_block": [(N16_BLOCKS, N16_BLOCKS.replace("2", "1"))],
}
# the kernels each copy is timed on
TIMED = {name: ("tile",) for name in COPIES}
TIMED["whole"] = ("tile", "state_pass", "tc_pass", "tile_n16", "tile_n16_dtx")
TIMED["no_products"] = TIMED["no_stores"] = ("tile", "tile_n16")
TIMED["n16_one_block"] = ("tile_n16", "tile_n16_dtx")
TIMED["pass_no_c_h"] = ("state_pass",)
TIMED.update({name: ("tc_pass",) for name in COPIES if name.startswith("tc_")})


def ref64(dtx, cum, b, c):
    """The tile's function in float64 (ref.ssd_chunk_ref's formulas)."""
    import torch
    Q = dtx.shape[2]
    x = dtx.double().permute(0, 1, 3, 2, 4)
    cm = cum.double().permute(0, 1, 3, 2)
    bd, cd = b.double(), c.double()
    seg = cm[..., :, None] - cm[..., None, :]
    tril = torch.ones((Q, Q), dtype=torch.bool, device=dtx.device).tril()
    decay = torch.where(tril, torch.exp(torch.where(
        tril, seg, torch.full_like(seg, -1e300))), torch.zeros_like(seg))
    y = (((cd @ bd.transpose(-1, -2)).unsqueeze(2) * decay) @ x)
    w = torch.exp(cm[..., -1:] - cm)
    state = (bd.unsqueeze(2) * w.unsqueeze(-1)).transpose(-1, -2) @ x
    return y.permute(0, 1, 3, 2, 4), state


def accuracy(dev, gen):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as SS

    ok = True
    for c in ((S.SSD_SLICE,) + S.SSD_TILE_SHAPES
              + (S.JAMBA_SSD_SMALL, S.JAMBA_SSD_SLICE)):
        for dt in (torch.float32, torch.bfloat16):
            if SS.route(c["Q"], c["N"], c["P"], dt) not in SS.TENSOR_CORE_TILES:
                continue
            dtx, cum, bm, cm = S._ssd_inputs(gen, dev, c, dt)
            got = SS.ssd_chunk_tiles(dtx, cum, bm, cm)
            plain = ref.ssd_chunk_ref(dtx, cum, bm, cm)
            row = {"case": c, "bc_dtype": str(dt).split(".")[-1]}
            for name, out in (("tile", got), ("plain_float32", plain)):
                row[name] = [0.0, 0.0]
            for bi in range(c["B"]):       # one batch row at a time: memory
                want = ref64(dtx[bi:bi + 1], cum[bi:bi + 1], bm[bi:bi + 1],
                             cm[bi:bi + 1])
                for name, out in (("tile", got), ("plain_float32", plain)):
                    for k in range(2):
                        err = S.rel_err(out[k][bi:bi + 1].double(), want[k])[0]
                        row[name][k] = max(row[name][k], err)
                del want
            row["y_state_measure"] = "max |got - want| / (|want| + 1)"
            ok &= max(row["tile"]) <= S.SSD_TILE_TOL
            S.emit(row)
            del dtx, cum, bm, cm, got, plain
            S.empty_cache(dev)
    return ok


def build_copy(tmp, name, subs):
    from repro_torch.kernels import build
    src = (build.CSRC / "ssd_scan.cu").read_text()
    for line, new in subs:
        if src.count(line) != 1:
            raise SystemExit(f"ssd_scan.cu: {line.strip()!r} moved; update "
                             "tools/ssd_probe.py")
        src = src.replace(line, new)
    cu = os.path.join(tmp, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(tmp, f"lib{name}.so")
    made = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-shared", "-o", lib, cu],
                          check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.ssd_chunk_wgmma_launch.argtypes = [p] * 4 + [i] * 6 + [p] * 3
    dll.ssd_chunk_wgmma_xdt_launch.argtypes = [p] * 5 + [i] * 6 + [p] * 3
    dll.ssd_state_pass_launch.argtypes = [p] * 4 + [i] * 9 + [p] * 3
    dll.ssd_state_pass_wgmma_launch.argtypes = [p] * 4 + [i] * 9 + [p] * 3
    return dll, n16_registers(made.stdout + made.stderr)


def n16_registers(log):
    """ptxas's registers and spill bytes of each ssd_chunk_wgmma_n16_kernel
    instance in a build log, by its mangled template arguments."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            key = "ssd_chunk_wgmma_n16_kernel"
            name = entry.split(key)[1][:40] if key in entry else None
        elif name is not None and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out.setdefault(name, {})["spill_store_load_bytes"] = nums[-2:]
        elif name is not None and "Used" in line and "registers" in line:
            words = line.split()
            out.setdefault(name, {})["registers"] = int(
                words[words.index("Used") + 1])
    return out


def times(dev, gen):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import check, stream

    c = S.SSD_SLICE
    B, nc, Q, H, P, N = (c[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    dtx, cum, bm, cm = S._ssd_inputs(gen, dev, c, torch.bfloat16)
    xh, dts = dtx.bfloat16(), dtx[..., 0].abs() * 0.1
    y = torch.empty_like(dtx)
    st = torch.empty((B, nc, H, N, P), device=dev)
    out = torch.empty((B, nc * Q, H, P), dtype=torch.bfloat16, device=dev)
    final = torch.empty((B, H, N, P), device=dev)
    # jamba's tile at N 16: dt x on load from bf16 x (the main path's), and
    # on float32 dtx (as chip_smoke times it)
    j = S.JAMBA_SSD_SLICE
    jdtx, jcum, jbm, jcm = S._ssd_inputs(gen, dev, j, torch.bfloat16)
    jxh, jdts = jdtx.bfloat16(), jdtx[..., 0].abs() * 0.1
    jy = torch.empty_like(jdtx)
    jst = torch.empty((j["B"], j["nc"], j["H"], j["N"], j["P"]), device=dev)
    jwant = ref.ssd_chunk_ref(jdtx, jcum, jbm, jcm)
    jargs = (jcum.data_ptr(), jbm.data_ptr(), jcm.data_ptr(), 1,
             j["B"] * j["nc"], j["Q"], j["H"], j["N"], j["P"], jy.data_ptr(),
             jst.data_ptr(), stream(jxh))
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
            dlls = dict(zip(COPIES, pool.map(lambda kv: build_copy(tmp, *kv),
                                             COPIES.items())))
        for name, (dll, regs) in dlls.items():

            def tile():
                check(dll.ssd_chunk_wgmma_xdt_launch(
                    xh.data_ptr(), dts.data_ptr(), cum.data_ptr(),
                    bm.data_ptr(), cm.data_ptr(), 1, B * nc, Q, H, N, P,
                    y.data_ptr(), st.data_ptr(), stream(xh)), name)

            def tile_n16():
                check(dll.ssd_chunk_wgmma_xdt_launch(
                    jxh.data_ptr(), jdts.data_ptr(), *jargs), name)

            def tile_n16_dtx():
                check(dll.ssd_chunk_wgmma_launch(jdtx.data_ptr(), *jargs), name)

            def state_pass(launch):
                return lambda: check(launch(
                    y.data_ptr(), st.data_ptr(), cum.data_ptr(), cm.data_ptr(),
                    1, 1, B, nc, Q, H, N, P, nc * Q, out.data_ptr(),
                    final.data_ptr(), stream(xh)), name)

            fns = {"tile": tile, "tile_n16": tile_n16,
                   "tile_n16_dtx": tile_n16_dtx,
                   "state_pass": state_pass(dll.ssd_state_pass_launch),
                   "tc_pass": state_pass(dll.ssd_state_pass_wgmma_launch)}
            row = dict({"copy": name}, **{
                k + "_ms": S.time_ms(fns[k], reps=10) for k in TIMED[name]})
            if "tile_n16" in TIMED[name]:
                row["n16_ptxas"] = regs
            if name in ("whole", "n16_one_block"):   # outputs not broken
                tile_n16_dtx()
                row["n16_vs_plain"] = [S.rel_err(got, want)[0] for got, want
                                       in zip((jy, jst), jwant)]
            S.emit(row)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    S.device_line()
    gen = torch.Generator().manual_seed(4)
    ok = accuracy(dev, gen)
    times(dev, gen)
    S.emit({"tile_tol": S.SSD_TILE_TOL, "ok": ok})
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
