"""Algorithm 1's math on tensors: VFA problem, gains, trigger, server."""
