"""Carry state between the JAX package and the port.

The port never imports JAX, so it takes the reference's objects as numpy:
anything with ``__array__`` (numpy and JAX arrays alike) becomes a tensor on
the given device, dicts / lists / tuples map element-wise, and the
reference's ``ProblemTerms`` and ``EnvFamily`` become the port's types of
the same name.  PRNG keys cross as their data (``jax.random.key_data``), a
(..., 2) uint32 array the port's ``random`` module reads as int64 words.
``to_numpy`` goes back, so both packages can compute from one set of inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.algorithm1 import ProblemTerms
from repro_torch.envs.base import EnvFamily

_NAMED = {"ProblemTerms": ProblemTerms, "EnvFamily": EnvFamily}


def to_torch(tree, device="cpu"):
    """Numpy-convertible leaves -> tensors on ``device``; structure kept."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _NAMED.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(tree).__name__}")
        return cls(*(to_torch(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def key_to_torch(key_data, device="cpu") -> torch.Tensor:
    """Threefry key data (..., 2) uint32 -> the port's int64 key tensor."""
    return to_torch(np.asarray(key_data, np.uint32), device)


def to_numpy(tree):
    """Tensors -> numpy arrays; structure (and port NamedTuples) kept."""
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)
