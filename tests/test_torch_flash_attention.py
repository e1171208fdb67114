"""The port's flash-attention wrapper, plain path, against repro.kernels.

``repro_torch.kernels.flash_attention.flash_attention`` on CPU tensors
(its plain version) is held against the Pallas kernel run as
tests/test_kernels.py runs it (interpret mode) and against
``repro.kernels.ref.flash_attention_ref``, over the five cases of
tests/test_kernels.py:175-181 in float32 and bf16 at that test's
tolerances (3e-4 / 3e-2, rtol = atol).  Both sides get the same numpy
inputs.  The CUDA kernel runs only on the card (chip_smoke.py); here the
wrapper must refuse, not fall back, on any non-CPU tensor.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

CASES = [
    dict(B=2, Lq=64, Lk=64, H=4, KVH=4, D=32, causal=True, window=0),
    dict(B=1, Lq=128, Lk=128, H=8, KVH=2, D=64, causal=True, window=0),
    dict(B=2, Lq=100, Lk=100, H=4, KVH=1, D=16, causal=True, window=32),
    dict(B=1, Lq=96, Lk=96, H=2, KVH=2, D=128, causal=False, window=0),
    dict(B=1, Lq=160, Lk=160, H=2, KVH=1, D=64, causal=True, window=64),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 3e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _pair(rng, shape, dt):
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(DTYPES[dt][0])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dt][1])
    return j, t


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_matches_reference(rng, case, dt):
    c = case
    qj, qt = _pair(rng, (c["B"], c["Lq"], c["H"], c["D"]), dt)
    kj, kt = _pair(rng, (c["B"], c["Lk"], c["KVH"], c["D"]), dt)
    vj, vt = _pair(rng, (c["B"], c["Lk"], c["KVH"], c["D"]), dt)
    kw = dict(causal=c["causal"], window=c["window"])
    got = tflash.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    got = got.float().numpy()
    tol = DTYPES[dt][2]
    pallas = jflash(qj, kj, vj, block_q=32, block_k=32, interpret=True, **kw)
    oracle = jref.flash_attention_ref(qj, kj, vj, **kw)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_gqa_reads_the_shared_kv_head(rng):
    """Query head h sees kv head h // (H / KVH): with KVH=2 of H=4, heads
    0-1 and 2-3 must equal attention over an explicitly repeated kv."""
    _, q = _pair(rng, (1, 20, 4, 16), "f32")
    _, k = _pair(rng, (1, 20, 2, 16), "f32")
    _, v = _pair(rng, (1, 20, 2, 16), "f32")
    got = tflash.flash_attention(q, k, v)
    rep = lambda x: x.repeat_interleave(2, dim=2)
    torch.testing.assert_close(got, tref.flash_attention_ref(q, rep(k), rep(v)),
                               rtol=0, atol=0)


def test_cpu_tensors_never_count_launches(rng):
    tflash.reset_launches()
    _, q = _pair(rng, (1, 8, 2, 16), "f32")
    tflash.flash_attention(q, q, q)
    assert tflash.LAUNCHES == {"flash_attention": 0}


def test_non_cpu_tensors_raise_instead_of_falling_back():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="span devices"):
        tflash.flash_attention(q, torch.zeros((1, 8, 2, 16)), q)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel runs in chip_smoke.py")
    q = torch.zeros((1, 8, 2, 48), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        tflash.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 16), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tflash.flash_attention(q, q, q)
