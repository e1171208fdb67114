"""Hand-written CUDA kernels for the gain hot spot and their plain oracles."""
