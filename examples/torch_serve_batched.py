"""Serving example on the PyTorch/CUDA port: batched greedy decoding with
per-family KV/state caches (``examples/serve_batched.py`` on
``repro_torch``).

Runs three different cache disciplines from the zoo, each at its reduced
config with random weights:
  * phi3    — dense causal KV cache
  * mixtral — sliding-window ring cache (+ MoE decode)
  * mamba2  — O(1) recurrent state (no KV at all)

The prompt is the reference's (``randint`` of key 1, the port's threefry
draws JAX's bit for bit); the weights come from a ``torch.Generator``
seeded with 0, so they are not the reference's numbers.

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""

import argparse

BATCH, PROMPT, GEN = 4, 32, 16
ARCHS = ("phi3-mini-3.8b", "mixtral-8x7b", "mamba2-370m")


def prompt_tokens(cfg, device):
    """The reference's prompt: ``randint(key(1), (BATCH, PROMPT), 0, V)``."""
    from repro_torch import random as trandom
    return trandom.randint(trandom.key(1, device), (BATCH, PROMPT), 0,
                           cfg.vocab_size)


def cache_kind(cfg) -> str:
    return ("recurrent-state" if cfg.arch_type == "ssm" else
            f"ring[{cfg.sliding_window}]" if cfg.sliding_window else
            "dense-KV")


def decode(model, cfg, device) -> dict:
    """Step the decode path over the prompt, then ``GEN`` greedy tokens:
    ``{"tokens" (BATCH, GEN), "logits" (the last step's), "seconds"}``."""
    import torch
    from repro_torch.launch.serve import generate
    res = generate(model, cfg, prompt_tokens(cfg, device), GEN, device)
    if not bool(torch.isfinite(res["logits"]).all()):
        raise RuntimeError(f"{cfg.name}: non-finite logits")
    return dict(tokens=res["tokens"], logits=res["logits"],
                seconds=res["prefill_s"] + res["decode_s"])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the CPU)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = resolve_device(args.device)
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, dev, seed=0)
        res = decode(model, cfg, dev)
        rate = BATCH * (PROMPT + GEN) / res["seconds"]
        sample = res["tokens"][0, :8].tolist()
        out[arch] = dict(cache=cache_kind(cfg), tokens_per_s=rate,
                         sample=sample)
        print(f"{arch:16s} cache={cache_kind(cfg):16s} "
              f"{rate:7.1f} tok/s  sample={sample}")
    return out


if __name__ == "__main__":
    main()
