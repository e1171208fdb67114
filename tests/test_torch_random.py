"""repro_torch.random against jax.random (threefry2x32, partitionable).

Bits, key, split, fold_in, uniform, bernoulli and randint are compared for
exact equality; categorical exactly except at argmax near-ties (torch's and
XLA's ``log`` may differ in the last ulp); gumbel and normal within a few
ulp, and normal and truncated_normal (through ``xla_log1p`` and
``erfinv``) bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro_torch import random as R  # noqa: E402

SEEDS = (0, 1, 42, 2**31 - 1)


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_threefry_vectors():
    np.testing.assert_array_equal(R.key(0).numpy(), [0, 0])
    np.testing.assert_array_equal(
        R.split(R.key(0), 2).numpy(),
        [[1797259609, 2579123966], [928981903, 3453687069]])


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_fold_in_exact(seed):
    jk, tk = jax.random.key(seed), R.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _data(jk))
    np.testing.assert_array_equal(R.split(tk, 7).numpy(),
                                  _data(jax.random.split(jk, 7)))
    np.testing.assert_array_equal(R.fold_in(tk, 0x5444).numpy(),
                                  _data(jax.random.fold_in(jk, 0x5444)))
    # nested splits through batched keys: (3, 4, 2)
    nested = jax.vmap(lambda k: jax.random.split(k, 4))(jax.random.split(jk, 3))
    np.testing.assert_array_equal(R.split(R.split(tk, 3), 4).numpy(),
                                  _data(nested))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_randint_exact(seed):
    jk, tk = jax.random.key(seed), R.key(seed)
    np.testing.assert_array_equal(
        R.random_bits(tk, (3, 5)).numpy(),
        np.asarray(jax.random.bits(jk, (3, 5))).astype(np.int64))
    np.testing.assert_array_equal(R.uniform(tk, (2000,)).numpy(),
                                  np.asarray(jax.random.uniform(jk, (2000,))))
    np.testing.assert_array_equal(
        R.bernoulli(tk, 0.3, (2000,)).numpy(),
        np.asarray(jax.random.bernoulli(jk, 0.3, (2000,))))
    for lo, hi in ((0, 7), (0, 4), (3, 260)):
        np.testing.assert_array_equal(
            R.randint(tk, (2000,), lo, hi).numpy(),
            np.asarray(jax.random.randint(jk, (2000,), lo, hi)))


def test_batched_keys_match_vmapped_jax():
    """A (runs, agents) grid of keys draws in one call, as jax.vmap does."""
    jks = jax.random.split(jax.random.key(3), 6).reshape(2, 3)
    tks = torch.from_numpy(_data(jks))
    want_u = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (4, 5))))(jks)
    np.testing.assert_array_equal(R.uniform(tks, (4, 5)).numpy(),
                                  np.asarray(want_u))
    p = np.asarray([[0.1, 0.5, 0.9], [0.3, 0.0, 1.0]], np.float32)
    want_b = jax.vmap(jax.vmap(lambda k, q: jax.random.bernoulli(
        k, q, (8,))))(jks, jnp.asarray(p))
    np.testing.assert_array_equal(
        R.bernoulli(tks, torch.from_numpy(p).unsqueeze(-1), (8,)).numpy(),
        np.asarray(want_b))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_gumbel_and_normal_within_ulps(seed):
    jk, tk = jax.random.key(seed), R.key(seed)
    # ulps of the output, floored at the scale of the last rounding step:
    # gumbel = -log(t) of t = -log(u) near 1 cancels to values near 0
    for got, want, floor in (
            (R.gumbel(tk, (20000,)), jax.random.gumbel(jk, (20000,)), 1.0),
            (R.normal(tk, (20000,)), jax.random.normal(jk, (20000,)), 1e-3)):
        got, want = got.numpy(), np.asarray(want)
        ulp = np.spacing(np.maximum(np.abs(want), floor).astype(np.float32))
        assert np.max(np.abs(got.astype(np.float64) - want) / ulp) <= 4


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_normal_and_log1p_bitwise(seed):
    """``normal`` = sqrt(2) erf_inv(u) as XLA's CPU code rounds it: its
    log1p (``xla_log1p``, Cephes' rational below sqrt(2) - 1), the Giles
    polynomial in fused multiply-adds and a correctly rounded sqrt."""
    jk, tk = jax.random.fold_in(jax.random.key(seed), 17), R.fold_in(
        R.key(seed), 17)
    np.testing.assert_array_equal(R.normal(tk, (3, 40000)).numpy(),
                                  np.asarray(jax.random.normal(jk, (3, 40000))))
    x = np.random.default_rng(seed).uniform(-0.999, 4.0, 50000).astype(
        np.float32)
    x[:4] = (0.0, -0.41421354, 0.41421357, 1e-30)
    np.testing.assert_array_equal(R.xla_log1p(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.lax.log1p(jnp.asarray(x))))


@pytest.mark.parametrize("bounds", [(-2.0, 2.0), (-1.0, 3.0)])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_truncated_normal_bitwise(seed, bounds):
    """``truncated_normal`` = sqrt(2) erf_inv(u), u on [erf(lo/sqrt 2),
    erf(hi/sqrt 2)) scaled with XLA's fused multiply-add, clipped to the
    open interval: the draw the reference's weight initialisers make."""
    jk, tk = jax.random.key(seed), R.key(seed)
    lo, hi = bounds
    np.testing.assert_array_equal(
        R.truncated_normal(tk, (7, 3000), lo, hi).numpy(),
        np.asarray(jax.random.truncated_normal(jk, lo, hi, (7, 3000))))


def _near_tie(key, logits, shape, idx_a, idx_b, tol=1e-5):
    """True when the two argmax candidates of JAX's gumbel+logits score
    within ``tol`` of each other (the only place the streams may part)."""
    g = np.asarray(jax.random.gumbel(key, shape + logits.shape[-1:]))
    s = g + logits
    a = np.take_along_axis(s, idx_a[..., None], -1)[..., 0]
    b = np.take_along_axis(s, idx_b[..., None], -1)[..., 0]
    return np.abs(a - b) <= tol * (np.abs(a) + 1.0)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_exact_except_near_ties(seed, rng):
    jk, tk = jax.random.key(seed), R.key(seed)
    # visit-style logits drawn once per key, sample dims in front
    lg = rng.normal(size=(9,)).astype(np.float32)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(lg),
                                             shape=(5000,)))
    got = R.categorical(tk, torch.from_numpy(lg), shape=(5000,)).numpy()
    bad = got != want
    assert _near_tie(jk, lg, (5000,), got, want)[bad].all()
    # transition-style logits with a batch axis, log(P + 1e-30) zeros
    P = rng.dirichlet(np.ones(6), size=300).astype(np.float32)
    P[P < 0.1] = 0.0
    lg2 = np.log(P + np.float32(1e-30))
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(lg2), axis=-1))
    got = R.categorical(tk, torch.from_numpy(lg2)).numpy()
    bad = got != want
    assert _near_tie(jk, lg2, (300,), got, want)[bad].all()
    assert bad.sum() <= 1
