#!/usr/bin/env python3
"""Time gain_family_stats and megastep_call at chip_smoke.FAMILY_TIMED.

Each shape's inputs come from ``chip_smoke.family_inputs`` on a seeded
device generator, so two trees timed by this script see the same data.
``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
repository's by default): pointed at an unpacked older commit, it times
that commit's kernels with this commit's shapes and timer, so the two can
be compared in one call (old, new, new, old).  ``--blocks`` times the tree
under a ``REPRO_TORCH_KERNEL_BLOCKS`` value (repeatable; a tree that does
not read the variable ignores it), ``--check`` first holds every call
against its plain version (``chip_smoke.family_check``: WEIGHT_TOL,
decisions exact but for reported ties, repeated bitwise).

Needs one GPU with sm_90a and nvcc.  Run from the repository root:

    python3 tools/gain_family_timing.py [--src DIR] [--blocks SPEC ...]
        [--check] [--shapes LABEL,...] [--out FILE]

Prints the card's name and power limit, then one JSON object per
(setting, shape) with ``chip_smoke.family_timing``'s numbers for each
wrapper: ``ms`` (``time_ms``: a synchronize before each call, host checks
and launch included), ``ms_loop`` (``loop_ms``: back-to-back calls, what a
step loop pays), ``ms_graph`` (a CUDA graph's replay: device time), the
plain version's three, and ``bound_ms``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(REPO, "src"))
    ap.add_argument("--blocks", action="append", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated labels of FAMILY_TIMED to time")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    # the timed tree's package is imported first: its submodules then come
    # from it, whatever chip_smoke's imports put on sys.path
    src = os.path.abspath(args.src)
    sys.path[:0] = [src, REPO]
    import repro_torch
    import torch

    import chip_smoke as S
    from repro_torch.kernels import build
    from repro_torch.kernels import gain as K
    from repro_torch.kernels import ref
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not {src}")

    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    made = build.build()
    print(json.dumps({"src": src, "library": str(made.path),
                      "nvcc_seconds": made.seconds}), flush=True)
    rows = []
    for spec in args.blocks or [""]:
        gen = torch.Generator(device=dev).manual_seed(2)
        logs = {k: S.KernelLog() for k in ("gain_family_stats", "megastep")}
        for label, shape, onehot in S.FAMILY_TIMED:
            inp = S.family_inputs(dev, gen, shape, onehot)
            if args.shapes and label not in args.shapes.split(","):
                continue
            with S.blocks_env(spec or None):
                if args.check:
                    S.family_check(logs, label, inp)
                times = S.family_timing(K, ref, inp)
            row = dict(card=card, blocks=spec, shape=label,
                       R_m_T_n=list(shape), **times)
            if args.check:
                row["max_abs_err"] = {k: v.max_abs for k, v in logs.items()}
            print(json.dumps(row), flush=True)
            rows.append(row)
            del inp
            S.empty_cache(dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()
