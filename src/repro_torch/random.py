"""Counter-based random streams that reproduce ``jax.random`` bit for bit.

JAX's default generator is threefry2x32 in the *partitionable* layout: a
draw of shape ``s`` from key ``k`` hashes the 64-bit row-major index of
every element, split into (hi, lo) 32-bit words, under ``k``; ``split``
and ``fold_in`` are the same hash at counters ``(0, i)`` and ``(0, data)``.
Because the hash is a pure function of (key, counter), this module keeps
keys as data — integer tensors of shape ``(..., 2)`` — so one call draws
for every run and agent of a sweep at once, the written-out counterpart of
``jax.vmap`` over key arrays.

Torch has no shifts for ``uint32`` on the CPU, so every word is an
``int64`` tensor holding a value in ``[0, 2**32)`` and each operation is
masked back to 32 bits.

What matches ``jax.random`` exactly: the raw bits, ``key``, ``split``,
``fold_in``, ``uniform``, ``bernoulli``, ``randint`` and
``truncated_normal``.  ``categorical``
(Gumbel-argmax) and ``normal`` (inverse error function) follow JAX's own
algorithms on the same bits, but their ``log`` / ``log1p`` are torch's,
which may differ from XLA's in the last ulp: ``normal`` agrees within a
few ulp, ``categorical`` exactly except at argmax near-ties.
"""

from __future__ import annotations

import math
import struct
from typing import Callable, Optional, Sequence

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_ONE_BITS = 0x3F800000
_F32_TINY = torch.finfo(torch.float32).tiny
# largest float32 below -1's neighbour towards zero: jax's normal() lower edge
_NORMAL_LO = -0.99999994


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``'s data: ``[seed >> 32, seed & 0xFFFFFFFF]``."""
    seed = int(seed)
    hi = (seed >> 32) & MASK32 if not -2**31 <= seed < 2**31 else 0
    return torch.tensor([hi, seed & MASK32], dtype=torch.int64, device=device)


def keys(seeds: Sequence[int], device=None) -> torch.Tensor:
    """Stacked ``key(s)`` for each seed: (len(seeds), 2)."""
    return torch.stack([key(s, device) for s in seeds])


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor,
                 x0: torch.Tensor, x1: torch.Tensor):
    """The 20-round Threefry-2x32 hash of counters (x0, x1) under (k0, k1).

    All four are int64 tensors of 32-bit words, broadcast together; the
    result is the pair of hashed words.  Works in place on two full-size
    buffers so a draw of N elements holds three N-sized tensors at most.
    """
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.contiguous(), x1.contiguous()
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK32)
            torch.bitwise_left_shift(x1, r, out=tmp)
            x1.bitwise_right_shift_(32 - r).bitwise_or_(tmp)
            x1.bitwise_and_(MASK32).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK32)
    return x0, x1


def _hash_at(keys_: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor):
    """Hash the 64-bit counters ``(hi, lo)`` (two word tensors of shape
    ``c``) under keys ``(*B, 2)``: returns two (*B, *c) word tensors."""
    nb = keys_.dim() - 1
    view = keys_.shape[:-1] + (1,) * lo.dim()
    k0 = keys_[..., 0].reshape(view)
    k1 = keys_[..., 1].reshape(view)
    hi = hi.reshape((1,) * nb + hi.shape)
    lo = lo.reshape((1,) * nb + lo.shape)
    return threefry2x32(k0, k1, hi, lo)


def split(keys_: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` of every key: (*B, 2) -> (*B, num, 2)."""
    ctr = torch.arange(num, dtype=torch.int64, device=keys_.device)
    b0, b1 = _hash_at(keys_, torch.zeros_like(ctr), ctr)
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys_: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` of every key: (*B, 2) -> (*B, 2)."""
    ctr = torch.tensor([int(data) & MASK32], dtype=torch.int64,
                       device=keys_.device)
    b0, b1 = _hash_at(keys_, torch.zeros_like(ctr), ctr)
    return torch.stack([b0[..., 0], b1[..., 0]], dim=-1)


def random_bits(keys_: torch.Tensor, shape: Sequence[int],
                start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words as int64): (*B, *shape).

    With ``start`` the draw is the slice of a larger one that begins at
    flat element ``start``: counters are positional, so a draw of shape
    (n, *rest) at ``start = i * prod(rest)`` equals rows i..i+n of the
    whole draw, bit for bit.  Element i hashes the 64-bit counter
    ``start + i`` as its (hi, lo) words, as JAX's partitionable threefry
    does (``iota_2x32_shape``); like JAX, a draw of more than 2**64
    elements (the larger draw's, with ``start``) is refused.
    """
    shape = tuple(shape)
    count = math.prod(shape)
    if start < 0 or start + count > 2**64:
        raise NotImplementedError("random bits array of size exceeding 2 ** 64")
    # start's low word plus i stays far inside int64; its carry goes high
    base = start & MASK32
    lo = torch.arange(base, base + count, dtype=torch.int64,
                      device=keys_.device)
    if base + count <= 2**32:
        hi = torch.full_like(lo, start >> 32)
    else:
        hi = ((lo >> 32) + (start >> 32)) & MASK32
        lo.bitwise_and_(MASK32)
    b0, b1 = _hash_at(keys_, hi, lo)
    return b0.bitwise_xor_(b1).reshape(keys_.shape[:-1] + shape)


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """Mantissa trick: 23 high bits under exponent 0 -> float32 in [0, 1)."""
    fb = (bits >> 9) | _F32_ONE_BITS
    return fb.to(torch.int32).view(torch.float32) - 1.0


def _scale(floats: torch.Tensor, minval: float, maxval: float):
    lo = torch.tensor(minval, dtype=torch.float32, device=floats.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=floats.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def uniform(keys_: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, start: int = 0) -> torch.Tensor:
    """``jax.random.uniform`` (float32): (*B, *shape); ``start`` as in
    ``random_bits``."""
    return _scale(_bits_to_unit(random_bits(keys_, shape, start)), minval,
                  maxval)


def bernoulli(keys_: torch.Tensor, p, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` (bool).

    ``p`` is a float or a float32 tensor broadcastable to (*B, *shape).
    """
    u = uniform(keys_, shape)
    if not torch.is_tensor(p):
        p = torch.tensor(p, dtype=torch.float32, device=u.device)
    return u < p.to(torch.float32)


def randint(keys_: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` (int32 semantics, int64 result): (*B, *shape).

    Two 32-bit draws per value, from ``split(key)``, folded into the span
    with JAX's multiplier identity.
    """
    span = max(int(maxval) - int(minval), 1)
    sub = split(keys_, 2)
    hb = random_bits(sub[..., 0, :], shape)
    lb = random_bits(sub[..., 1, :], shape)
    mult = (2 ** 16 % span) ** 2 % span
    off = (((hb % span) * mult) & MASK32) + (lb % span)
    return int(minval) + (off & MASK32) % span


def gumbel(keys_: torch.Tensor, shape: Sequence[int], start: int = 0,
           log: Optional[Callable] = None) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, mode="low"): (*B, *shape),
    ``-log(-log(uniform(tiny, 1)))``; ``start`` as in ``random_bits``.
    ``log`` defaults to torch's (correctly rounded); ``xla_log`` gives
    XLA's CPU rounding, bit for bit."""
    u = uniform(keys_, shape, _F32_TINY, 1.0, start)
    if log is None:
        return u.log_().neg_().log_().neg_()
    return log(log(u).neg_()).neg_()


def categorical(keys_: torch.Tensor, logits: torch.Tensor,
                shape: Optional[Sequence[int]] = None, start: int = 0,
                log: Optional[Callable] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1, shape)`` per key.

    ``logits`` is (*B, *batch, K) with B the key batch; ``shape`` (default
    ``batch``) is each key's result shape and may add leading sample dims,
    exactly as JAX's ``shape`` argument.  Gumbel-argmax over K, first index
    on ties.  Returns (*B, *shape) int64.  ``start`` and ``log`` go to
    ``gumbel``: a draw of leading sample rows i..i+n of a larger ``shape``
    passes that slice's shape and ``start = i * prod(rest) * K``.
    """
    nb = keys_.dim() - 1
    batch = tuple(logits.shape[nb:-1])
    shape = batch if shape is None else tuple(shape)
    prefix = shape[:len(shape) - len(batch)]
    K = logits.shape[-1]
    g = gumbel(keys_, prefix + batch + (K,), start, log)
    lg = logits.reshape(logits.shape[:nb] + (1,) * len(prefix)
                        + logits.shape[nb:])
    return torch.argmax(g.add_(lg), dim=-1)


# Giles' single-precision erfinv coefficients, as XLA expands erf_inv
_ERFINV_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 inverse error function by XLA's algorithm (Giles 2010).

    ``log1p`` is XLA's (``xla_log1p``), the square root correctly rounded
    (taken in float64: torch's float32 ``sqrt`` on the CPU is not always),
    and the Horner steps run as fused multiply-adds (exact float64 product
    and sum, one rounding to float32), as XLA's CPU code runs them: the
    result is XLA's bit for bit (``tests/test_torch_random.py``), where
    ``torch.erfinv`` uses another approximation and differs by up to ~1e-5.
    """
    w = -xla_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0).double()

    def coef(i):
        return torch.where(lt, _ERFINV_W_LT5[i], _ERFINV_W_GE5[i]).float()

    p = coef(0)
    for i in range(1, len(_ERFINV_W_LT5)):
        p = (coef(i).double() + p.double() * w).float()
    big = torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1, x * big, p * x)


def normal(keys_: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.normal`` (float32): ``sqrt(2) * erfinv(uniform(lo, 1))``."""
    u = uniform(keys_, shape, _NORMAL_LO, 1.0)
    return erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32,
                                    device=u.device)


def truncated_normal(keys_: torch.Tensor, shape: Sequence[int],
                     lower: float = -2.0, upper: float = 2.0) -> torch.Tensor:
    """``jax.random.truncated_normal`` (float32), bit for bit: ``sqrt(2) *
    erfinv(u)`` with ``u`` uniform on ``[erf(lower / sqrt 2), erf(upper /
    sqrt 2))``, clipped to the open interval (lower, upper).  XLA scales
    the uniform draw onto that range with a fused multiply-add, so ``u``
    is formed by ``_fma`` here (``uniform``'s ranges are exact either
    way)."""
    # the interval's constants on the CPU, so every device gets their bits
    sqrt2 = torch.tensor(math.sqrt(2), dtype=torch.float32)
    lo = torch.tensor(lower, dtype=torch.float32)
    hi = torch.tensor(upper, dtype=torch.float32)
    inf = torch.tensor(math.inf)
    a, b, lo_open, hi_open, sqrt2 = (
        t.to(keys_.device) for t in (
            torch.erf(lo / sqrt2), torch.erf(hi / sqrt2),
            torch.nextafter(lo, inf), torch.nextafter(hi, -inf), sqrt2))
    floats = _bits_to_unit(random_bits(keys_, shape))
    u = torch.maximum(a, _fma(floats, b - a, a))
    return torch.clamp(erfinv(u) * sqrt2, lo_open, hi_open)


def _f32(c: float) -> float:
    """The float32 nearest ``c``, as a Python float."""
    return struct.unpack("f", struct.pack("f", c))[0]


# Cephes' logf coefficients (float32), as XLA's CPU backend expands log
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), 0.693359375
_SQRT_HALF = 0.707106781186547524


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c with one rounding (exact float64 product and sum)."""
    return (a.double() * b + c).float()


# Cephes' log1p rational approximation (float64 coefficients, numerator
# and denominator from the highest degree down), as XLA expands log1p
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG1P_SMALL = 0.41421356237309504880        # sqrt(2) - 1


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` rounded exactly as XLA's CPU code rounds it.

    For |x| < sqrt(2) - 1, x - x^2/2 + x^3 P(x)/Q(x) with Cephes' rational
    P/Q, each polynomial a chain of fused multiply-adds; otherwise
    ``xla_log(1 + x)``.  ``jax.random.normal`` reaches it through
    ``erf_inv``; torch's ``log1p`` differs from it in the last ulp for ~1
    in 12 inputs there.
    """
    f32 = torch.float32
    x = x.to(f32)
    xd = x.double()
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = _fma(num, xd, _f32(cn))
        den = _fma(den, xd, _f32(cd))
    x2 = x * x
    small = x + (-0.5 * x2 + (x * x2) * (num / den))
    return torch.where(x.abs() < _f32(_LOG1P_SMALL), small, xla_log(x + 1.0))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 natural log rounded exactly as XLA's CPU code rounds it.

    XLA expands ``log`` into Cephes' polynomial (frexp, a shift into
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in fused multiply-adds);
    it is not correctly rounded, and torch's ``log`` differs from it in
    the last ulp for ~1 in 7 inputs, enough to flip a Gumbel argmax.
    Each step here rounds to float32 where XLA's does, so results are
    XLA's bit for bit on both devices.  Subnormal inputs count as zero,
    as XLA's CPU code flushes them.
    """
    f32 = torch.float32
    xc = torch.clamp(x.to(f32), min=_F32_TINY)
    bits = xc.view(torch.int32).to(torch.int64)
    e = ((bits >> 23) - 0x7E).to(f32)                     # frexp exponent
    m = ((bits & 0x807FFFFF) | 0x3F000000).to(torch.int32).view(f32)
    low = m < _SQRT_HALF                                  # m in [0.5, 1)
    e = e - low.to(f32)
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    t2 = t * t
    t3 = t2 * t
    td = t.double()
    y = _fma(td, _LOG_P[0], _LOG_P[1])
    y1 = _fma(td, _LOG_P[3], _LOG_P[4])
    y2 = _fma(td, _LOG_P[6], _LOG_P[7])
    y = _fma(y, td, _LOG_P[2])
    y1 = _fma(y1, td, _LOG_P[5])
    y2 = _fma(y2, td, _LOG_P[8])
    t3d = t3.double()
    y = _fma(y, t3d, y1.double())
    y = _fma(y, t3d, y2.double())
    y = _fma(y, t3d, (e * _LOG_Q1).double())
    out = (t - t2 * 0.5) + y
    out = out + e * _LOG_Q2
    out = torch.where(x < _F32_TINY, torch.full_like(out, -math.inf), out)
    out = torch.where(x == math.inf, torch.full_like(out, math.inf), out)
    return torch.where((x < 0) | torch.isnan(x),
                       torch.full_like(out, math.nan), out)
