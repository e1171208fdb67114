"""Carry state between the JAX package and the port.

The port never imports JAX, so it takes the reference's objects as numpy:
anything with ``__array__`` (numpy and JAX arrays alike) becomes a tensor on
the given device, dicts / lists / tuples map element-wise, and the
reference's ``ProblemTerms`` and ``EnvFamily`` become the port's types of
the same name.  PRNG keys cross as their data (``jax.random.key_data``), a
(..., 2) uint32 array the port's ``random`` module reads as int64 words.
``to_numpy`` goes back, so both packages can compute from one set of inputs.
``model_from_jax`` loads an LM's parameter tree (as numpy) into the port's
``nn.Module`` of the same config; ``state_dict_to_jax`` goes back, so
parameters, gradients and optimizer moments cross in both directions.  Like every entry point of the port, the
functions that make tensors default to ``device="cuda"`` and raise without
a GPU (``repro_torch.resolve_device``); the tests pass ``device="cpu"``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.algorithm1 import ProblemTerms
from repro_torch.envs.base import EnvFamily
from repro_torch.models import build_model

_NAMED = {"ProblemTerms": ProblemTerms, "EnvFamily": EnvFamily}


def to_torch(tree, device=None):
    """Numpy-convertible leaves -> tensors on ``device``; structure kept."""
    return _to_torch(tree, resolve_device(device))


def _to_torch(tree, device: torch.device):
    if tree is None:
        return None
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _NAMED.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port counterpart for {type(tree).__name__}")
        return cls(*(_to_torch(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def key_to_torch(key_data, device=None) -> torch.Tensor:
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


def _tensor(leaf) -> torch.Tensor:
    """One array as a tensor of the same dtype (bf16 included)."""
    if torch.is_tensor(leaf):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


# The reference's stacked subtrees: a leading layer axis consumed by
# ``lax.scan`` (a decoder's ``blocks``, an encoder-decoder's ``enc_blocks``
# and ``dec_blocks``), and inside each hybrid super-block a leading axis
# over its mamba2 mixers, MoE MLPs and dense MLPs.  The port holds each stack as an
# ``nn.ModuleList`` (``<name>.<i>.<...>``); an MoE's (E, d, ff) expert
# stacks stay one tensor.
_STACKS = {"blocks": (), "enc_blocks": (), "dec_blocks": (),
           "superblocks": ("mamba", "moe", "mlp")}


def _split(key: str, t: torch.Tensor, out: dict) -> None:
    """One reference leaf -> the port's leaves, split along each stacked
    axis its key passes through."""
    top, _, rest = key.partition(".")
    if top not in _STACKS or not rest:
        out[key] = t
        return
    inner, _, leaf = rest.partition(".")
    for i in range(t.shape[0]):
        if inner in _STACKS[top] and leaf:
            for j in range(t.shape[1]):
                out[f"{top}.{i}.{inner}.{j}.{leaf}"] = t[i, j]
        else:
            out[f"{top}.{i}.{rest}"] = t[i]


def state_dict_from_jax(params: dict) -> dict:
    """The reference's LM parameter tree -> the port module's state_dict.

    Nested dict keys join with "." (a frontend's ``projector.w1``); the
    stacked ``blocks`` leaves are split along axis 0 into
    ``blocks.<i>.<...>`` of the ``nn.ModuleList``, an encoder-decoder's
    ``enc_blocks`` and ``dec_blocks`` likewise, and a hybrid's
    ``superblocks`` into ``superblocks.<i>.<...>``, with their
    ``mamba`` / ``moe`` / ``mlp`` stacks split once more into
    ``superblocks.<i>.mamba.<j>.<...>``.  Dtypes are kept.
    """
    out: dict = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                _split(f"{prefix}{k}", _tensor(v), out)

    walk(params, "")
    return out


def _stack(sd: dict, pattern: str) -> dict:
    """Keys ``<head>.<i>.<rest>`` whose head matches ``pattern`` (a regex)
    -> ``<head>.<rest>``, the leaves stacked along a new axis 0 in index
    order; other keys unchanged."""
    rx = re.compile(rf"({pattern})\.(\d+)\.(.+)")
    out, groups = {}, {}
    for key, t in sd.items():
        m = rx.fullmatch(key)
        if m is None:
            out[key] = t
        else:
            groups.setdefault(f"{m[1]}.{m[3]}", {})[int(m[2])] = t
    for key, per in groups.items():
        if sorted(per) != list(range(len(per))):
            raise ValueError(f"{key}: indices {sorted(per)} are not 0..n-1")
        out[key] = torch.stack([per[i] for i in range(len(per))])
    return out


def tree_from_state_dict(sd: dict) -> dict:
    """The inverse of ``state_dict_from_jax``, in tensors: the inner stacks
    of each super-block, then ``blocks.<i>`` / ``enc_blocks.<i>`` /
    ``dec_blocks.<i>`` / ``superblocks.<i>`` stack
    along a new axis 0 (in index order), and "."-joined keys nest again
    into the reference's tree.  Dtypes are kept; this is the tree a
    checkpoint stores."""
    for top, inner in _STACKS.items():
        if inner:
            sd = _stack(sd, rf"{top}\.\d+\.(?:{'|'.join(inner)})")
    sd = _stack(sd, "|".join(_STACKS))
    out: dict = {}
    for key, t in sd.items():
        _nest(out, key, t)
    return out


def _nest(tree: dict, key: str, value) -> None:
    *path, last = key.split(".")
    for part in path:
        tree = tree.setdefault(part, {})
    tree[last] = value


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 as ``ml_dtypes.bfloat16``, JAX's numpy
    bf16 (imported only for bf16 tensors)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def state_dict_to_jax(sd: dict) -> dict:
    """A port ``state_dict``-keyed dict (parameters, gradients, moments)
    -> the reference's tree as numpy, ``blocks`` stacked."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else _numpy(v)
                for k, v in tree.items()}

    return walk(tree_from_state_dict(sd))


def model_from_jax(cfg, params_np: dict, device=None):
    """The port's model of ``cfg`` holding the reference's parameters
    ``params_np`` (its ``model.init`` tree as numpy), on ``device``
    (default cuda; raises without a GPU unless ``device="cpu"``)."""
    model = build_model(cfg, device)
    sd = state_dict_from_jax(params_np)
    own = model.state_dict()
    if set(sd) != set(own):
        raise ValueError(f"parameter trees differ: missing "
                         f"{sorted(set(own) - set(sd))}, extra "
                         f"{sorted(set(sd) - set(own))}")
    for k, t in sd.items():
        if t.dtype != own[k].dtype or t.shape != own[k].shape:
            raise ValueError(f"{k}: {t.dtype} {tuple(t.shape)} != "
                             f"{own[k].dtype} {tuple(own[k].shape)}")
    model.load_state_dict(sd)
    return model
