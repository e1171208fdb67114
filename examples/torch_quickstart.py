"""Quickstart on the PyTorch/CUDA port: the paper in ~60 lines
(``examples/quickstart.py`` on ``repro_torch``).

Two agents jointly fit the value function of a random-walk policy on the
5x5 windy grid (paper §V, Fig. 2), communicating only when their local
data is informative enough (eq. 9 with the practical estimate eq. 15).
Algorithm 1's inner loop runs at three communication prices on the card
(``--device cpu`` runs the plain-torch path instead).

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse

import numpy as np

LAMBDAS = (1e-4, 1e-2, 1e-1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for the CPU)")
    args = ap.parse_args(argv)

    from repro_torch import random as trandom
    from repro_torch import resolve_device
    from repro_torch.core.algorithm1 import GatedSGDConfig, run_gated_sgd
    from repro_torch.core.trigger import TriggerConfig
    from repro_torch.envs import GridWorld

    dev = resolve_device(args.device)
    # 1. the MDP and the exact quantities we need for evaluation
    gw = GridWorld()                              # 5x5, windy top row, goal G
    v_current = np.zeros(gw.num_states)           # initial value guess
    problem = gw.vfa_problem(v_current)           # population problem (3)
    w0 = np.zeros(gw.num_states, np.float32)
    j0 = float(problem.objective(problem.phi_matrix.new_tensor(w0)))
    j_star = float(problem.objective(problem.optimum()))
    print(f"J(w0) = {j0:.4f}, J(w*) = {j_star:.2e}")

    # 2. stability constants from the paper's Assumptions 2-3
    eps = 0.5
    rho = problem.min_rho(eps) * 1.0001
    print(f"eps = {eps} (max stable {problem.max_stable_stepsize():.2f}), "
          f"rho = {rho:.4f}")

    # 3. Algorithm 1's inner loop at three communication prices
    sampler = gw.make_sampler(v_current, num_samples=10)
    out = dict(J_w0=j0, J_star=j_star, rho=rho, runs={})
    for lam in LAMBDAS:
        cfg = GatedSGDConfig(
            trigger=TriggerConfig(lam=lam, rho=rho, num_iterations=250),
            eps=eps, num_agents=2, mode="practical",   # eq. 15, model-free
        )
        trace = run_gated_sgd(trandom.key(0, dev), w0, sampler, cfg,
                              problem=problem, device=dev)
        j_final = float(problem.objective(trace.weights[-1].cpu()))
        rate = float(trace.comm_rate)
        out["runs"][lam] = dict(comm_rate=rate, J_final=j_final)
        print(f"lambda={lam:7.0e}  comm rate={rate:5.1%}  "
              f"J(w_N)={j_final:.2e}")

    print("\nHigher lambda => less communication, gracefully worse J — "
          "the tradeoff Theorem 1 guarantees.")
    return out


if __name__ == "__main__":
    main()
