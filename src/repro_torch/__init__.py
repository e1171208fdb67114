"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

Module for module it mirrors ``repro`` (``repro_torch/core/algorithm1.py``
ports ``repro/core/algorithm1.py``, and so on) and is held against it by
the ``tests/test_torch_*.py`` parity tests.  It imports torch and numpy
only: where it needs code that ``repro`` also has, it keeps its own copy.

Every entry point takes ``device=`` and defaults to ``"cuda"``; on a
machine without a GPU it raises unless the caller asks for the CPU
explicitly (``device="cpu"``, as the tests do).  The kernels are
hand-written CUDA (``repro_torch/kernels/csrc/``), built on first use by
``repro_torch.kernels.build``.  Entry points: the sweep engine
(``experiments.sweep.run_sweep`` and the resumable runtime), serving of
every model family of ``repro`` (ssm, dense, MoE, hybrid, the
encoder-decoder and the vision-prefix decoder: ``python -m
repro_torch.launch.serve``) and federated gain-gated training
of the LM substrate (``python -m repro_torch.launch.train``, or
``launch.train.train``), and the sweep service (``experiments.report``,
``experiments.serve_sweeps``), which never imports torch.

Importing the package imports no torch, so ``faults`` and the serving
half of ``experiments`` (``store``, ``query``, ``report``, ``registry``,
``serve_sweeps``, ``client``) run on numpy and the stdlib alone.
"""

from __future__ import annotations


def resolve_device(device=None) -> "torch.device":
    """The device an entry point runs on: ``device`` or, by default, cuda.

    Raises when CUDA is asked for (explicitly or by default) and there is
    none, so a run never drops to the CPU without the caller saying so.
    """
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain-torch path")
    return dev
