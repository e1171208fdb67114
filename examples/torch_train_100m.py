"""End to end on the PyTorch/CUDA port: train a ~100M-parameter
Mamba2 LM with gain-gated federated aggregation
(``examples/train_100m.py`` on ``repro_torch``).

The model is mamba2-370m trimmed to 8 layers in float32 (8 x 6.6M + 51M
embedding, ~100M parameters), with random weights from a
``torch.Generator`` seeded with 0; the batches are the reference's (key
2, bit for bit).  4 agents (the reference's 4 XLA host devices) gate with
the ``gnorm`` estimator, adamw on a cosine schedule.  The default is a
20-step slice of the program; ``--steps 300`` is the full run.

  PYTHONPATH=src python examples/torch_train_100m.py --steps 20 [--device cpu]
"""

import argparse
import dataclasses
import time

AGENTS = 4
LR = 3e-4


def config():
    """~100M params: the mamba2-370m family trimmed to 8 layers."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("mamba2-370m"), num_layers=8,
                               dtype="float32", remat=False, loss_chunk=128)


def param_count(model) -> int:
    """The number of trained values (the reference's parameter leaves)."""
    return sum(p.numel() for p in model.parameters())


def train(model, cfg, steps: int = 20, seq_len: int = 256,
          global_batch: int = 4, lam: float = 1e-4, device=None,
          log=print, log_every: int = 5) -> dict:
    """``steps`` gated steps over ``AGENTS`` agents; logs the reference's
    lines every ``log_every`` steps and returns the logged steps' loss,
    comm rate and seconds a step."""
    from repro_torch import random as trandom
    from repro_torch import resolve_device
    from repro_torch.core.fed_sgd import FedConfig, FedStats
    from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
    from repro_torch.launch.steps import build_train_step, trainable_params
    from repro_torch.optim import adamw, cosine_schedule

    dev = resolve_device(device)
    fed = FedConfig(eps=1.0, lam=lam, rho=0.999, horizon=steps,
                    estimator="gnorm")     # gnorm: no HVP second pass
    opt = adamw(cosine_schedule(LR, warmup=max(steps // 10, 1), total=steps))
    bundle = build_train_step(model, cfg, opt, fed_cfg=fed,
                              num_agents=AGENTS, device=dev)
    params = trainable_params(model)
    opt_state = opt.init(params)
    fed_state = FedStats.init(bundle.num_agents, dev)
    lm = SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                           global_batch=global_batch)
    key = trandom.key(2, dev)
    history = []
    t0 = time.time()
    for step in range(steps):
        batch = make_lm_batch(lm, key, step)
        params, opt_state, fed_state, m = bundle.step(params, opt_state,
                                                      fed_state, batch)
        if step % log_every == 0 or step == steps - 1:
            s_step = (time.time() - t0) / (step + 1)
            history.append(dict(step=step, loss=float(m["loss"]),
                                comm_rate=float(m["comm_rate"]),
                                s_per_step=s_step))
            log(f"step {step:4d}  loss {float(m['loss']):.4f}  "
                f"comm {float(m['comm_rate']):.2f}  {s_step:.3f}s/step")
    log("done.")
    return dict(history=history, wall_s=time.time() - t0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--lam", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the CPU)")
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.models import build_model

    dev = resolve_device(args.device)
    cfg = config()
    model = build_model(cfg, dev, seed=0)
    n = param_count(model)
    print(f"model: {cfg.name} x {cfg.num_layers}L  params = {n / 1e6:.1f}M")
    out = train(model, cfg, steps=args.steps, seq_len=args.seq_len,
                global_batch=args.global_batch, lam=args.lam, device=dev)
    out["params"] = n
    return out


if __name__ == "__main__":
    main()
