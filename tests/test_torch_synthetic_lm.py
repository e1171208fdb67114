"""repro_torch.data.synthetic_lm against repro.data.synthetic_lm.

The LM batch (tokens, targets, mask) equals the reference's bit for bit
for several (seed, step) pairs at the vocabularies of mamba2-370m (50280)
and yi-6b (64000) and a reduced one, at small B and L; drawing the Gumbel
tensor a slice of rows at a time gives the same tokens; and
``random.xla_log``, which the draw's logs go through, equals XLA's float32
``log`` bit for bit where torch's ``log`` differs in the last ulp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.data import synthetic_lm as jlm  # noqa: E402

from repro_torch import random as trandom  # noqa: E402
from repro_torch.data import synthetic_lm as tlm  # noqa: E402

CASES = [  # (vocab, batch, seq_len, seed, step)
    (50280, 2, 16, 0, 0),
    (50280, 3, 70, 1, 2),
    (64000, 2, 33, 5, 7),
    (64000, 1, 8, 1, 0),
    (1024, 8, 128, 1, 1),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool spinning beside them costs more than it gains at these
    sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(vocab, batch, seq_len, seed, step):
    want = jlm.make_lm_batch(jlm.SyntheticLMConfig(vocab, seq_len, batch),
                             jax.random.key(seed), step)
    got = tlm.make_lm_batch(tlm.SyntheticLMConfig(vocab, seq_len, batch),
                            trandom.key(seed), step)
    return want, got


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_lm_batch_bitwise(case):
    want, got = _pair(*case)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["tokens"].dtype == torch.int64
    assert got["mask"].dtype == torch.float32


def test_row_slices_give_the_whole_draw(monkeypatch):
    cfg = tlm.SyntheticLMConfig(1024, 40, 5)
    whole = tlm.make_lm_batch(cfg, trandom.key(3), 4)
    monkeypatch.setattr(tlm, "_SLICE_ELEMS", 2 * 40 * 1024)   # 2 rows a slice
    sliced = tlm.make_lm_batch(cfg, trandom.key(3), 4)
    for k in whole:
        assert torch.equal(whole[k], sliced[k]), k


def test_targets_shift_left_and_last_position_masked():
    b = tlm.make_lm_batch(tlm.SyntheticLMConfig(64000, 12, 2),
                          trandom.key(0), 0)
    assert torch.equal(b["targets"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["mask"][:, -1], torch.zeros(2))
    assert bool((b["mask"][:, :-1] == 1).all())
    assert bool(((b["tokens"] >= 0) & (b["tokens"] < 64000)).all())


def test_xla_log_bitwise():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2**32, size=200_000, dtype=np.uint64).astype(np.uint32)
    u = ((bits >> 9) | 0x3F800000).view(np.float32) - np.float32(1)
    u = np.maximum(np.float32(np.finfo(np.float32).tiny), u)
    xs = np.concatenate([u, -np.log(u.astype(np.float64)).astype(np.float32),
                         np.arange(1, 64001, dtype=np.float32),
                         np.array([0, 1, np.inf, -1, np.nan, 1e-40, 3e38],
                                  np.float32)])
    want = np.asarray(jnp.log(jnp.asarray(xs)))
    got = trandom.xla_log(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, want)
    # what xla_log is for: torch's correctly rounded log is not XLA's
    plain = torch.log(torch.from_numpy(xs[:200_000])).numpy()
    assert (plain != want[:200_000]).sum() > 1000
