"""Serving entry point: batched prefill + token-by-token decode, ported from
``repro/launch/serve.py`` for every arch of the reference (ssm, dense,
MoE, hybrid, the encoder-decoder seamless-m4t-medium and the vision-prefix
internvl2-2b).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \
      --prompt-len 64 --gen-len 32 --batch 4 --device cpu

As in the reference's loop, serving takes tokens only: a vision model
serves without its patches, and an encoder-decoder decodes over the zero
memory ``init_cache`` leaves (bulk prefill with patches or frames is
``launch.steps.build_prefill_step``).

The flags are the reference's plus ``--device`` (default cuda).  As in the
reference, ``--reduced`` is ``store_true`` with ``default=True``, so the
command line always serves the reduced config; ``serve()`` takes any
config, and ``chip_smoke.py`` calls it with the full one.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch.steps import build_serve_step
from repro_torch.models import build_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(model, cfg: ModelConfig, tokens: torch.Tensor, gen_len: int,
             device=None) -> dict:
    """Prefill by stepping the decode path over the prompt ``tokens``
    (B, prompt_len), then ``gen_len`` greedy tokens, as the reference's
    serve loop does.  Returns ``tokens`` (B, gen_len), the last ``logits``
    and the host-clock ``prefill_s`` / ``decode_s`` (synchronized)."""
    dev = resolve_device(device)
    batch, prompt_len = tokens.shape
    max_len = prompt_len + gen_len
    shape = ShapeConfig("serve", max_len, batch, "decode")
    step, init_cache = build_serve_step(model, cfg, shape, dev)
    cache = init_cache()
    tokens = tokens.to(dev)

    # prefill by stepping the decode path (keeps the cache layout uniform for
    # every family; bulk prefill is build_prefill_step)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = step(cache, tokens[:, t], t)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    cur = torch.argmax(logits, dim=-1)
    for t in range(prompt_len, max_len):
        out.append(cur)
        logits, cache = step(cache, cur, t)
        cur = torch.argmax(logits, dim=-1)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return {"tokens": torch.stack(out, dim=1), "logits": logits,
            "prefill_s": prefill_s, "decode_s": decode_s}


def serve(cfg: ModelConfig, batch: int = 4, prompt_len: int = 64,
          gen_len: int = 32, seed: int = 0, device=None) -> dict:
    """Build ``cfg``'s model with random weights from ``seed``, draw a
    random prompt from the same seed and serve it (``generate``)."""
    dev = resolve_device(device)
    model = build_model(cfg, dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    return generate(model, cfg, tokens, gen_len, dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the plain path)")
    args = ap.parse_args(argv)
    if args.model_axis != 1:
        ap.error("--model-axis: the port serves on one device (1)")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = serve(cfg, args.batch, args.prompt_len, args.gen_len, args.seed,
                args.device)
    gen_s = res["decode_s"]
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} gen={args.gen_len} "
          f"device={resolve_device(args.device)}")
    print(f"[serve] prefill {res['prefill_s']:.2f}s  decode {gen_s:.2f}s "
          f"({args.gen_len * args.batch / max(gen_s, 1e-9):.1f} tok/s)")
    print(f"[serve] sample tokens: {res['tokens'][0, :16].tolist()}")
    assert bool(torch.isfinite(res["logits"]).all()), "non-finite logits"
    print("[serve] OK")


if __name__ == "__main__":
    main()
