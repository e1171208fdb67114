#!/usr/bin/env python3
"""How many bf16 pieces the tensor-core state pass needs, on the CPU.

Runs the emulation of the tensor-core tile and state pass from
``tests/test_torch_ssd.py`` (``_tensor_core_chunked``) against the JAX
package's ``ssd_chunked_pallas(interpret=True)`` over 16 single-sequence
inputs (seeds 0-7 at L = 512 and 500, mamba2's widths) for bf16 C with h
in three, two and one bf16 pieces and float32 C with h and C in three and
two, and prints
each case's max |got - want| / (2e-4 + 2e-4 |want|): above 1 leaves the
chunked path's tolerance.  Needs jax and torch (CPU).  Run from the
repository root:

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/ssd_pass_pieces.py
"""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.join(REPO, "src"))

import test_torch_ssd as T  # noqa: E402


def main():
    for c_dtype, pieces in (("bf16", 3), ("bf16", 2), ("bf16", 1), ("f32", 3),
                            ("f32", 2)):
        ratios = []
        for seed in range(8):
            for L in (512, 500):
                rng = np.random.default_rng(seed * 1000 + L)
                (y, _), (yj, _) = T._tensor_core_chunked(rng, L, c_dtype,
                                                         pieces)
                yj = np.asarray(yj)
                ratios.append(float(np.max(np.abs(y.numpy() - yj)
                                           / (2e-4 + 2e-4 * np.abs(yj)))))
        print(json.dumps({"c": c_dtype, "h_pieces": pieces,
                          "max": max(ratios), "min": min(ratios),
                          "over_tolerance": sum(r > 1 for r in ratios),
                          "cases": len(ratios)}))


if __name__ == "__main__":
    main()
