#!/usr/bin/env python3
"""Time gain_matvec and practical_gain across their T-tile (``block_t``)
on the card, beside ``torch.matmul`` on the same inputs.

Shapes (agents x T x n, dtype): the kernel suite's one agent (4096 x 2048)
in float32, bf16 and float16, a ragged one-agent long-T case (4097 x
1030, the generic pass), the suite's family shape 64 x 1024 x 512 in
float16 and wide-192's 12,288 x 128 x 256 (every sweep's one tile).  At
each, the default tiling (``kernels/gain.py::matvec_geometry``) and every
``BLOCK_TS`` value up to T, then T itself (one tile an agent, one block
an agent: the layout before T-tiles): ``chip_smoke.time_ms`` (a
synchronize before each call) and ``chip_smoke.time_graph_ms`` (a CUDA
graph's replay: device time), and the outputs' bits, which must not move
with ``block_t``.

Needs one GPU with sm_90a and nvcc.  Run from the repository root:

    python3 tools/matvec_block_t.py [--out FILE]

Prints the card's name and power limit, one JSON line per (shape,
block_t) and exits 1 if any tiling changed a bit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_TS = (8, 16, 32, 64, 128, 256, 512)
SHAPES = (("kernel suite", (1, 4096, 2048), "float32"),
          ("kernel suite", (1, 4096, 2048), "bfloat16"),
          ("kernel suite", (1, 4096, 2048), "float16"),
          ("ragged long T", (1, 4097, 1030), "float32"),
          ("family suite", (64, 1024, 512), "float16"),
          ("wide-192", (12288, 128, 256), "float32"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [os.path.join(REPO, "src"), REPO]
    import torch

    import chip_smoke as S
    from repro_torch.kernels import gain as K
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, moved = [], 0
    for label, (m, T, n), dtn in SHAPES:
        dt = getattr(torch, dtn)
        shape = (m, T, n) if m > 1 else (T, n)
        phi = torch.randn(shape, device=dev, generator=gen).to(dt)
        g = torch.randn(shape[:-2] + (n,), device=dev, generator=gen).to(dt)
        b_ms, b_by = S.bound(S.nbytes(phi, g) + m * T * 4, 2 * m * T * n)
        lib = dict(ms=S.time_ms(lambda: torch.matmul(phi, g.unsqueeze(-1))),
                   ms_graph=S.time_graph_ms(
                       lambda: torch.matmul(phi, g.unsqueeze(-1))))
        base = (K.gain_matvec(phi, g), K.practical_gain(phi, g, 0.5))
        default = K.matvec_geometry(T, n, dt)
        for bt in [None] + [b for b in BLOCK_TS if b < T] + [T]:
            geo = K.matvec_geometry(T, n, dt, bt)
            mv = lambda: K.gain_matvec(phi, g, block_t=bt)
            pg = lambda: K.practical_gain(phi, g, 0.5, block_t=bt)
            equal = all(torch.equal(x, y) for x, y in zip((mv(), pg()), base))
            moved += not equal
            row = dict(shape=label, agents_T_n=[m, T, n], dtype=dtn,
                       block_t=geo.block_t, tiles=geo.tiles,
                       default=bt is None or geo == default,
                       matvec_ms=S.time_ms(mv),
                       matvec_ms_graph=S.time_graph_ms(mv),
                       practical_gain_ms=S.time_ms(pg),
                       practical_gain_ms_graph=S.time_graph_ms(pg),
                       matmul_ms=lib["ms"], matmul_ms_graph=lib["ms_graph"],
                       bound_ms=b_ms, bound_by=b_by, bitwise_equal=equal)
            rows.append(row)
            print(json.dumps(row), flush=True)
        del phi, g, base
        torch.cuda.empty_cache()
    summary = {"rows": len(rows), "tilings_that_moved_bits": moved,
               "card": card}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f, indent=1)
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
