"""Training driver: federated gain-gated training of the LM substrate,
ported from ``repro/launch/train.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --reduced --steps 20 --lam 1e-3 --log-every 5 --agents 4 --device cpu

The flags and output lines are the reference's, with two changes:
``--agents`` (the number of simulated agents, default 1) takes the place
of the mesh's federation-axis size, and so of ``--host-mesh`` and
``--model-axis``; ``--device`` (default cuda) is the port's, as in
``serve``.  Weights are drawn from a ``torch.Generator`` seeded with
``--seed``, so they are not the reference's numbers; the batches are
(``repro_torch.data.synthetic_lm``, bit for bit).
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch import random, resolve_device
from repro_torch.checkpoint import save as save_ckpt
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import tree_from_state_dict
from repro_torch.core.fed_sgd import FedConfig, FedStats
from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
from repro_torch.launch.steps import build_train_step, trainable_params
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_schedule


def make_batch_fn(cfg: ModelConfig, seq_len: int, global_batch: int):
    """``fn(rng, step)`` -> the synthetic LM batch of ``step`` on ``rng``'s
    device, with the reference's stub frontend embeddings: a vision config's
    num_prefix patches take the first positions of the ``seq_len`` budget
    (its token, target and mask columns cut to ``[:, P:]``) and an audio
    config's frames come beside the tokens, both ``0.02 * normal`` of a
    key folded from ``rng`` (17 and 19), the same every step, bit for bit
    the reference's draws."""
    lm = SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                           global_batch=global_batch)
    P = cfg.num_prefix

    def fn(rng, step):
        batch = make_lm_batch(lm, rng, step)
        if cfg.frontend == "vision":
            batch = {k: v[:, P:] if v.shape[1] > P else v
                     for k, v in batch.items()}
            batch["prefix_emb"] = 0.02 * random.normal(
                random.fold_in(rng, 17), (global_batch, P, cfg.frontend_dim))
        elif cfg.frontend == "audio":
            batch["prefix_emb"] = 0.02 * random.normal(
                random.fold_in(rng, 19), (global_batch, P, cfg.frontend_dim))
        return batch

    return fn


def train(cfg: ModelConfig, steps: int = 50, seq_len: int = 256,
          global_batch: int = 8, lr: float = 3e-4, lam: float = 0.0,
          rho: float = 0.999, estimator: str = "hvp", agents: int = 1,
          log_every: int = 10, checkpoint: str = "", seed: int = 0,
          device=None, log=print) -> dict:
    """The driver's run: ``steps`` federated steps of ``cfg``'s model with
    adamw on a cosine schedule, gated when ``lam > 0``.  Returns
    ``{"final", "history", "model", "bundle", "params", "opt_state",
    "fed_state"}`` (the run's train step and its last state); ``log``
    receives the reference's output lines."""
    dev = resolve_device(device)
    model = build_model(cfg, dev, seed)
    fed_cfg = FedConfig(eps=1.0, lam=lam, rho=rho, horizon=steps,
                        estimator=estimator)
    opt = adamw(cosine_schedule(lr, warmup=max(steps // 10, 1), total=steps))
    bundle = build_train_step(model, cfg, opt,
                              fed_cfg=fed_cfg if lam > 0 else None,
                              num_agents=agents, device=dev)
    params = trainable_params(model)
    opt_state = opt.init(params)
    fed_state = FedStats.init(bundle.num_agents, dev)
    batch_fn = make_batch_fn(cfg, seq_len, global_batch)
    rng = random.key(seed, dev)

    log(f"[train] arch={cfg.name} agents={bundle.num_agents} "
        f"fed_axis={fed_cfg.axis} lam={lam} estimator={estimator} "
        f"device={dev}")
    t0 = time.time()
    history = []
    for step in range(steps):
        batch = batch_fn(rng, step)
        params, opt_state, fed_state, metrics = bundle.step(
            params, opt_state, fed_state, batch)
        if step % log_every == 0 or step == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t0, 2)
            history.append(m)
            log(f"[train] step={step:5d} loss={m['loss']:.4f} "
                f"gnorm={m['grad_norm']:.3f} comm_rate={m['comm_rate']:.3f} "
                f"({m['wall_s']}s)")

    if checkpoint:
        save_ckpt(checkpoint, tree_from_state_dict(model.state_dict()),
                  metadata={"arch": cfg.name, "steps": steps,
                            "history": history})
        log(f"[train] checkpoint -> {checkpoint}")
    return {"final": history[-1], "history": history, "model": model,
            "bundle": bundle, "params": params, "opt_state": opt_state,
            "fed_state": fed_state}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced (CPU-scale) variant of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lam", type=float, default=0.0,
                    help="communication price lambda (0 => always transmit)")
    ap.add_argument("--rho", type=float, default=0.999)
    ap.add_argument("--estimator", choices=("hvp", "gnorm"), default="hvp")
    ap.add_argument("--agents", type=int, default=1,
                    help="simulated agents (the federation axis' size)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    out = train(cfg, steps=args.steps, seq_len=args.seq_len,
                global_batch=args.global_batch, lr=args.lr, lam=args.lam,
                rho=args.rho, estimator=args.estimator, agents=args.agents,
                log_every=args.log_every, checkpoint=args.checkpoint,
                seed=args.seed, device=args.device)
    print(json.dumps({"final": out["final"]}))


if __name__ == "__main__":
    main()
