"""The gain trigger as a first-class feature of distributed LM training,
on the PyTorch/CUDA port (``examples/federated_lm_training.py`` on
``repro_torch``).

8 federated agents, each on its own rows of the global batch, computes the
gradient of its shard, estimates the second-order gain of contributing it
(the deep-net analogue of eq. 15, via an exact Hessian-vector product) and
joins the masked mean over transmitters (eq. 6).  The reference puts the
agents on 8 XLA host devices (the mesh's ``data`` axis); on one card they
are ``build_train_step(..., num_agents=8)``, one CUDA graph each.  The
model is the reduced olmoe-1b-7b (a tiny MoE of the same family) with
random weights from a ``torch.Generator`` seeded with 0; the batches are
the reference's (key 1, bit for bit).

  PYTHONPATH=src python examples/torch_federated_lm_training.py [--device cpu]
"""

import argparse

ARCH = "olmoe-1b-7b"
AGENTS = 8
FED = dict(eps=1.0, lam=3e-4, rho=0.995, horizon=40, estimator="hvp")
LR = 3e-4


def train(model, cfg, steps: int = 20, seq_len: int = 128,
          global_batch: int = 8, device=None, log=print,
          log_every: int = 5) -> dict:
    """``steps`` gated steps of ``model`` with adamw(3e-4) over ``AGENTS``
    agents; logs the reference's lines every ``log_every`` steps and
    returns the logged steps' loss, comm rate and last decisions, and the
    final comm rate."""
    from repro_torch import random as trandom
    from repro_torch import resolve_device
    from repro_torch.core.fed_sgd import FedConfig, FedStats
    from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
    from repro_torch.launch.steps import build_train_step, trainable_params
    from repro_torch.optim import adamw

    dev = resolve_device(device)
    opt = adamw(LR)
    bundle = build_train_step(model, cfg, opt, fed_cfg=FedConfig(**FED),
                              num_agents=AGENTS, device=dev)
    params = trainable_params(model)
    opt_state = opt.init(params)
    fed_state = FedStats.init(bundle.num_agents, dev)
    lm = SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                           global_batch=global_batch)
    key = trandom.key(1, dev)
    history = []
    for step in range(steps):
        batch = make_lm_batch(lm, key, step)
        params, opt_state, fed_state, m = bundle.step(params, opt_state,
                                                      fed_state, batch)
        if step % log_every == 0 or step == steps - 1:
            alphas = fed_state.last_alpha[:8].tolist()
            history.append(dict(step=step, loss=float(m["loss"]),
                                comm_rate=float(m["comm_rate"]),
                                last_alphas=alphas))
            log(f"step {step:3d}  loss {float(m['loss']):.4f}  "
                f"comm rate {float(m['comm_rate']):.2f}  "
                f"last alphas {alphas}")
    rate = float(fed_state.comm_rate())
    log(f"\ncross-agent gradient exchanges skipped: {100 * (1 - rate):.0f}% "
        "(the bytes a pod-granular launcher saves)")
    return dict(history=history, comm_rate=rate)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the CPU)")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = resolve_device(args.device)
    cfg = get_config(ARCH).reduced()           # tiny MoE of the same family
    model = build_model(cfg, dev, seed=0)
    print(f"{AGENTS} federated agents on {dev}")
    return train(model, cfg, steps=args.steps, device=dev)


if __name__ == "__main__":
    main()
