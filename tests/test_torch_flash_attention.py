"""The port's flash-attention wrapper, plain path, against repro.kernels.

``repro_torch.kernels.flash_attention.flash_attention`` on CPU tensors
(its plain version) is held against the Pallas kernel run as
tests/test_kernels.py runs it (interpret mode) and against
``repro.kernels.ref.flash_attention_ref``, over the five cases of
tests/test_kernels.py:175-181, plus two at head dim 96 (phi3-mini's) and
seven with Lk != Lq (the encoder-decoder's cross-attention: causal and
not, Lq below and above Lk, GQA, ragged Lk, a window under which every row
sees a key, and Lq = 4, decode-vs-prefill's t = 3), in float32 and bf16 at
that test's tolerances (3e-4 / 3e-2, rtol = atol).  Both sides get the
same numpy inputs.  The CUDA kernels run only on the card (chip_smoke.py); here the
wrapper must refuse, not fall back, on any non-CPU tensor.

The tensor-core route (bf16, head dims 64, 96 and 128) is held on the CPU
through ``_emulate_wgmma``, a plain-torch emulation of its arithmetic: bf16
q and k, float32 scores scaled after the product, the online softmax over
64-key tiles in the exp2 domain, P split into a hi/lo pair of bf16 and
float32 accumulation.  Its float32 output (before the kernel's rounding to
bf16) must agree with the reference on the same bf16-rounded inputs at the
float32 tolerance; a single bf16 P must not.  The emulation also shows
that chip_smoke.py's bf16 ulp check of the kernel can fail: rounded to
bf16, the hi/lo split passes it and a single bf16 P does not.

The float32 kind of the same kernel (float32 q, k and v on 16-byte
boundaries at head dims that are multiples of 4 up to 128) is emulated
too: every float32 operand as three bf16 pieces, each product the six
piece products with a + b < 3 in the kernel's order (S's products summed
by order, the main one apart and added last; P V's smallest first),
32-key tiles, and each tile's P V added to O in float32.  It must agree
with the Pallas kernel and the reference at the float32 tolerance and lie
no farther from a float64 reference than twice the plain float32 path; a
hi/lo pair of pieces does not.
"""

import importlib.util
import pathlib
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
    # head dim 96 (phi3-mini's 3072 / 32): GQA causal, and a ragged length
    # with a window
    dict(B=1, Lq=128, Lk=128, H=4, KVH=2, D=96, causal=True, window=0),
    dict(B=2, Lq=100, Lk=100, H=2, KVH=2, D=96, causal=True, window=48),
]
# Lk != Lq: query row i and key j both count from 0, key j visible iff
# j < Lk, (causal) j <= i, (window w) j > i - w (the Pallas kernel's masks).
# A row that sees no key is outside the contract, so no case has one.
CROSS_CASES = [
    dict(B=2, Lq=48, Lk=100, H=4, KVH=2, D=64, causal=False, window=0),
    dict(B=1, Lq=130, Lk=72, H=4, KVH=4, D=128, causal=False, window=0),
    dict(B=1, Lq=40, Lk=96, H=4, KVH=1, D=64, causal=True, window=0),
    dict(B=2, Lq=100, Lk=60, H=2, KVH=2, D=128, causal=True, window=0),
    dict(B=1, Lq=80, Lk=64, H=4, KVH=2, D=64, causal=True, window=32),
    dict(B=2, Lq=4, Lk=130, H=4, KVH=4, D=64, causal=False, window=0),
    dict(B=1, Lq=70, Lk=33, H=2, KVH=1, D=32, causal=False, window=0),
]
CASES += CROSS_CASES
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
    assert tflash.LAUNCHES == {"flash_attention_wgmma": 0,
                               "flash_attention_wgmma_f16": 0,
                               "flash_attention_wgmma_padded": 0,
                               "flash_attention_wgmma_loaded": 0,
                               "flash_attention_wgmma_f32": 0,
                               "flash_attention_simt": 0,
                               "flash_attention_padded": 0,
                               "flash_attention_wide": 0}


def test_non_cpu_tensors_raise_instead_of_falling_back():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="span devices"):
        tflash.flash_attention(q, torch.zeros((1, 8, 2, 16)), q)


WGMMA_CASES = [c for c in CASES if c["D"] in tflash.WGMMA_HEAD_DIMS]


def _bf16_pieces(x, n):
    """x (float32) as n bf16 pieces, each held as float32: p0 = bf16(x),
    p_k = bf16(x - p0 - ... - p_{k-1}) (each remainder exact)."""
    out, r = [], x.float()
    for _ in range(n):
        out.append(r.bfloat16().float())
        r = r - out[-1]
    return out


def _small_pairs(n):
    """The piece products (a, b) with a + b < n but the main one (0, 0),
    smallest first, in the order the float32 kind runs P V's."""
    return [(a, o - a) for o in range(n - 1, 0, -1) for a in range(o + 1)]


def _emulate_wgmma(q, k, v, *, causal, window, split=True, block_k=64,
                   elem=torch.bfloat16, pieces=3):
    """float32 output of flash_wgmma_kernel's arithmetic before its final
    rounding to ``elem`` (bf16, or float16 for its f16 kind); q, k, v hold
    ``elem`` values (as any float dtype); q (B, Lq, H, D), k and v (B, Lk,
    KVH, D).  Any head dim: the kernel's columns past D are zeros, which
    add exact zeros to the scores and are never stored.  ``elem`` float32
    is the float32 kind (``_emulate_pieces``): q, k, v and P as ``pieces``
    bf16 pieces."""
    if elem == torch.float32:
        return _emulate_pieces(q, k, v, causal=causal, window=window,
                               pieces=pieces)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).to(elem).float()
    v = v.repeat_interleave(rep, dim=2).to(elem).float()
    q = q.to(elem).float()
    m = torch.full((B, H, Lq, 1), -1e30)
    l = torch.zeros((B, H, Lq, 1))
    acc = torch.zeros((B, H, Lq, D))
    qpos = torch.arange(Lq)[:, None]
    scale_log2 = D**-0.5 * 1.4426950408889634
    for k0 in range(0, Lk, block_k):
        kv = slice(k0, min(k0 + block_k, Lk))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k[:, kv]) * scale_log2
        j = torch.arange(kv.start, kv.stop)[None, :]
        vis = torch.ones((Lq, j.shape[1]), dtype=torch.bool)
        if causal:
            vis &= j <= qpos
        if window > 0:
            vis &= j > qpos - window
        s = torch.where(vis, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(elem).float()
        parts = (hi, (p - hi).to(elem).float()) if split else (hi,)
        acc = acc * corr
        for part in parts:
            acc = acc + torch.einsum("bhqk,bkhd->bhqd", part, v[:, kv])
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def _emulate_pieces(q, k, v, *, causal, window, pieces, block_k=32):
    """The float32 kind's arithmetic, each wgmma product a float32 einsum:
    32-key tiles; S = main + (block_{n-1} + ... + block_1), where block o
    sums the products Q_a K_{o-a} of order o from a = o down to 0 (the
    kernel's wgmmas Q_a [K_0 .. K_{n-1-a}]^T, a from n - 1 down) and main
    is Q_0 K_0; P split into pieces; each tile's P V (the small products,
    smallest first, then the main one) added to O."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    rep = H // k.shape[2]
    qp = _bf16_pieces(q, pieces)
    kp = _bf16_pieces(k.repeat_interleave(rep, dim=2), pieces)
    vp = _bf16_pieces(v.repeat_interleave(rep, dim=2), pieces)
    m = torch.full((B, H, Lq, 1), -1e30)
    l = torch.zeros((B, H, Lq, 1))
    acc = torch.zeros((B, H, Lq, D))
    qpos = torch.arange(Lq)[:, None]
    scale_log2 = D**-0.5 * 1.4426950408889634
    for k0 in range(0, Lk, block_k):
        kv = slice(k0, min(k0 + block_k, Lk))

        def score(a, b):
            return torch.einsum("bqhd,bkhd->bhqk", qp[a], kp[b][:, kv])
        small = torch.zeros(())
        for o in range(pieces - 1, 0, -1):
            block = torch.zeros(())
            for a in range(o, -1, -1):
                block = block + score(a, o - a)
            small = small + block
        s = (score(0, 0) + small) * scale_log2
        j = torch.arange(kv.start, kv.stop)[None, :]
        vis = torch.ones((Lq, j.shape[1]), dtype=torch.bool)
        if causal:
            vis &= j <= qpos
        if window > 0:
            vis &= j > qpos - window
        s = torch.where(vis, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pp = _bf16_pieces(p, pieces)
        part = torch.zeros(())
        for a, b in _small_pairs(pieces) + [(0, 0)]:
            part = part + torch.einsum("bhqk,bkhd->bhqd", pp[a], vp[b][:, kv])
        acc = acc * corr + part
        m = m_new
    return (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)


def _ref64(q, k, v, *, causal, window):
    """The reference's attention in float64."""
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    k = k.double().repeat_interleave(H // KVH, dim=2)
    v = v.double().repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k) * D**-0.5
    qp, kp = torch.arange(Lq)[:, None], torch.arange(Lk)[None, :]
    vis = torch.ones((Lq, Lk), dtype=torch.bool)
    if causal:
        vis &= kp <= qp
    if window > 0:
        vis &= kp > qp - window
    s = torch.where(vis, s, torch.full_like(s, -1e30))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def _bf16_case(rng, c):
    """q, k, v with bf16 values, as float32 (jax, torch) pairs."""
    return [_pair(rng, (c["B"], length, h, c["D"]), "bf16")
            for length, h in ((c["Lq"], c["H"]), (c["Lk"], c["KVH"]),
                              (c["Lk"], c["KVH"]))]


def _jax_f32(pairs):
    return [j.astype(jnp.float32) for j, _ in pairs]


@pytest.mark.parametrize("case", WGMMA_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_tensor_core_arithmetic_matches_reference(rng, case):
    """The hi/lo P split keeps the route at the float32 tolerance of the
    reference on the same bf16 inputs (3e-4, tests/test_kernels.py)."""
    c = case
    pairs = _bf16_case(rng, c)
    kw = dict(causal=c["causal"], window=c["window"])
    got = _emulate_wgmma(*(t.float() for _, t in pairs), **kw).numpy()
    qj, kj, vj = _jax_f32(pairs)
    pallas = jflash(qj, kj, vj, block_q=32, block_k=32, interpret=True, **kw)
    for want in (pallas, jref.flash_attention_ref(qj, kj, vj, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("case", WGMMA_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_single_bf16_p_leaves_the_float32_tolerance(rng, case):
    """With P rounded once to bf16 (FA2/FA3/SDPA's choice) the same inputs
    land measurably farther from the reference: beyond 3e-4, and more than
    ten times the hi/lo split's distance."""
    c = case
    pairs = _bf16_case(rng, c)
    kw = dict(causal=c["causal"], window=c["window"])
    inputs = [t.float() for _, t in pairs]
    want = np.asarray(jref.flash_attention_ref(*_jax_f32(pairs), **kw))
    err = {split: float(np.abs(_emulate_wgmma(*inputs, split=split, **kw)
                               .numpy() - want).max())
           for split in (True, False)}
    assert err[False] > 3e-4
    assert err[False] > 10 * err[True]


# the float32 kind's head dims: every case above (d 16 to 128, causal,
# window, GQA, Lk != Lq) and d 80 and 100 (multiples of 4, not of 8)
F32_CASES = CASES + [
    dict(B=1, Lq=70, Lk=70, H=4, KVH=2, D=80, causal=True, window=16),
    dict(B=1, Lq=40, Lk=90, H=2, KVH=1, D=100, causal=False, window=0),
    dict(B=2, Lq=100, Lk=100, H=4, KVH=2, D=100, causal=True, window=0)]


def _f32_case(rng, c):
    """float32 q, k, v as (jax, torch) pairs of the same values."""
    return [_pair(rng, (c["B"], length, h, c["D"]), "f32")
            for length, h in ((c["Lq"], c["H"]), (c["Lk"], c["KVH"]),
                              (c["Lk"], c["KVH"]))]


def _dist(got, want):
    return float((got.double() - want).abs().max())


@pytest.mark.parametrize("case", F32_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_float32_tensor_core_arithmetic_matches_reference(rng, case):
    """The float32 kind (three bf16 pieces, six products a product) agrees
    with the Pallas kernel (interpret mode) and the reference at the
    float32 tolerance (3e-4, tests/test_kernels.py), and lies no farther
    from a float64 reference than twice the plain float32 path."""
    c = case
    pairs = _f32_case(rng, c)
    kw = dict(causal=c["causal"], window=c["window"])
    q, k, v = (t for _, t in pairs)
    assert tflash.route(torch.float32, c["D"]) is tflash.WGMMA_F32
    assert tflash.cuda_route(q, k, v) is tflash.WGMMA_F32
    got = _emulate_wgmma(q, k, v, elem=torch.float32, **kw)
    qj, kj, vj = (j for j, _ in pairs)
    pallas = jflash(qj, kj, vj, block_q=32, block_k=32, interpret=True, **kw)
    for want in (pallas, jref.flash_attention_ref(qj, kj, vj, **kw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                                   atol=3e-4)
    want64 = _ref64(q, k, v, **kw)
    plain = _dist(tref.flash_attention_ref(q, k, v, **kw), want64)
    assert _dist(got, want64) <= 2 * plain


@pytest.mark.parametrize("case", F32_CASES[1::3], ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_fewer_float32_pieces_lose_float32_accuracy(rng, case):
    """A hi/lo pair of bf16 pieces (about 16 bits of each operand, three
    products a product) stays inside the 3e-4 tolerance on these inputs
    but lands more than five times as far from a float64 reference as the
    plain float32 path (the card's check allows two); three pieces land
    within it, and a single bf16 piece is outside the tolerance."""
    c = case
    q, k, v = (t for _, t in _f32_case(rng, c))
    kw = dict(causal=c["causal"], window=c["window"])
    want64 = _ref64(q, k, v, **kw)
    plain = _dist(tref.flash_attention_ref(q, k, v, **kw), want64)
    dist = {n: _dist(_emulate_wgmma(q, k, v, elem=torch.float32, pieces=n,
                                    **kw), want64) for n in (1, 2, 3)}
    assert dist[3] <= 2 * plain
    assert 5 * plain < dist[2] <= 3e-4
    assert dist[1] > 3e-4


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", WGMMA_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_bf16_ulp_check_sees_a_single_bf16_p(rng, case):
    """chip_smoke.bf16_ulps, as the card's check applies it to the kernel's
    bf16 output: the hi/lo split's rounded output stays within
    FLASH_ULP_LIMIT of the float32 reference, a single bf16 P's does not,
    while both stay inside FLASH_TOL's |want| + 1 scale."""
    smoke = _chip_smoke()
    c = case
    inputs = [t.float() for _, t in _bf16_case(rng, c)]
    kw = dict(causal=c["causal"], window=c["window"])
    want = tref.flash_attention_ref(*inputs, **kw)
    ulps = {}
    for split in (True, False):
        got = _emulate_wgmma(*inputs, split=split, **kw).bfloat16()
        ulps[split] = smoke.bf16_ulps(got, want)
        assert smoke.rel_err(got, want)[0] <= smoke.FLASH_TOL["bfloat16"]
    assert ulps[True] <= smoke.FLASH_ULP_LIMIT < ulps[False]


# head dims the tensor-core route takes at a padded width (64, 128, 256)
PADDED_CASES = [dict(B=1, Lq=70, Lk=70, H=4, KVH=2, D=D, causal=True,
                     window=16 if D == 80 else 0) for D in (8, 48, 80, 200, 256)]
PADDED_CASES.append(dict(B=1, Lq=40, Lk=90, H=2, KVH=1, D=136, causal=False,
                         window=0))
ELEMS = {"bf16": (jnp.bfloat16, torch.bfloat16),
         "f16": (jnp.float16, torch.float16)}


def _elem_case(rng, c, elem):
    """q, k, v holding ``elem`` values, as float32 (jax, torch) pairs."""
    out = []
    for length, h in ((c["Lq"], c["H"]), (c["Lk"], c["KVH"]),
                      (c["Lk"], c["KVH"])):
        a = rng.normal(size=(c["B"], length, h, c["D"])).astype(np.float32)
        j = jnp.asarray(a).astype(ELEMS[elem][0]).astype(jnp.float32)
        out.append((j, torch.from_numpy(np.array(j))))
    return out


@pytest.mark.parametrize("elem,case", [("bf16", c) for c in PADDED_CASES]
                         + [("f16", c) for c in WGMMA_CASES + PADDED_CASES],
                         ids=lambda x: x if isinstance(x, str) else "-".join(
                             f"{k}{v}" for k, v in x.items()))
def test_tensor_core_arithmetic_at_every_width_and_kind(rng, elem, case):
    """The tensor-core route's float16 kind (hi/lo float16 P) and its padded
    head dims (columns past d zero, scale d^-1/2): the float32 output is
    within the reference's float32 tolerance on the same inputs, and
    rounded to the input's type within chip_smoke's ulp limit of it
    (``f16_ulps`` for float16, ``bf16_ulps`` for bf16)."""
    smoke = _chip_smoke()
    c = case
    pairs = _elem_case(rng, c, elem)
    kw = dict(causal=c["causal"], window=c["window"])
    got = _emulate_wgmma(*(t for _, t in pairs), elem=ELEMS[elem][1], **kw)
    qj, kj, vj = _jax_f32(pairs)
    want = jref.flash_attention_ref(qj, kj, vj, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4,
                               atol=3e-4)
    ulps = (smoke.f16_ulps if elem == "f16" else smoke.bf16_ulps)(
        got.to(ELEMS[elem][1]), torch.from_numpy(np.array(want)))
    assert ulps <= smoke.FLASH_ULP_LIMIT


# head dims TMA cannot take (a row stride that is not a multiple of 16
# bytes): the loaded route's, whose consumers run the same arithmetic
LOADED_CASES = [dict(B=1, Lq=70, Lk=70, H=4, KVH=2, D=D, causal=True,
                     window=16 if D == 20 else 0) for D in (1, 20, 36)]
LOADED_CASES.append(dict(B=1, Lq=40, Lk=90, H=2, KVH=1, D=100, causal=False,
                         window=0))


@pytest.mark.parametrize("elem,case", [(e, c) for e in ("bf16", "f16")
                                       for c in LOADED_CASES],
                         ids=lambda x: x if isinstance(x, str) else "-".join(
                             f"{k}{v}" for k, v in x.items()))
def test_loaded_route_arithmetic_at_head_dims_off_the_tma_stride(
        rng, elem, case):
    """The loaded route at head dims 1, 20, 36 and 100 (zeros past d in
    every tile, scale d^-1/2 of the true d): the emulated float32 output is
    within the float32 tolerance of both the reference and the Pallas
    kernel (interpret mode) on the same inputs, and rounded to the input's
    type within chip_smoke's ulp limit of the reference."""
    smoke = _chip_smoke()
    c = case
    pairs = _elem_case(rng, c, elem)
    kw = dict(causal=c["causal"], window=c["window"])
    got = _emulate_wgmma(*(t for _, t in pairs), elem=ELEMS[elem][1], **kw)
    qj, kj, vj = _jax_f32(pairs)
    want = jref.flash_attention_ref(qj, kj, vj, **kw)
    pallas = jflash(qj, kj, vj, block_q=32, block_k=32, interpret=True, **kw)
    for other in (want, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(other), rtol=3e-4,
                                   atol=3e-4)
    ulps = (smoke.f16_ulps if elem == "f16" else smoke.bf16_ulps)(
        got.to(ELEMS[elem][1]), torch.from_numpy(np.array(want)))
    assert ulps <= smoke.FLASH_ULP_LIMIT
    assert tflash.route(ELEMS[elem][1], c["D"]) == tflash.WGMMA_LOADED


@pytest.mark.parametrize("elem", ["bf16", "f16"])
@pytest.mark.parametrize("D", [1, 2, 4, 7])
def test_ulp_check_at_rows_shorter_than_8_holds_on_every_seed(elem, D):
    """The loaded route at head dims below 8, over 20 seeds and the smoke's
    three contract masks: the emulated output, rounded to the input's type,
    is within chip_smoke's ulp limit of the reference on every seed.  At
    d 1 in bf16 the row's own rms (the element itself) would read past the
    limit on some seed, which is why short rows take their head's scale."""
    smoke = _chip_smoke()
    tdt = ELEMS[elem][1]
    ulps = smoke.f16_ulps if elem == "f16" else smoke.bf16_ulps
    worst = worst_row_scale = 0.0
    for seed in range(20):
        rng = np.random.default_rng(seed)
        for m in ({"Lk": 70, "causal": True, "window": 0},
                  {"Lk": 70, "causal": True, "window": 16},
                  {"Lk": 40, "causal": False, "window": 0}):
            kw = dict(causal=m["causal"], window=m["window"])
            xs = [torch.from_numpy(rng.normal(size=(1, length, heads, D))
                                   .astype(np.float32)).to(tdt).float()
                  for length, heads in ((70, 4), (m["Lk"], 2), (m["Lk"], 2))]
            got = _emulate_wgmma(*xs, elem=tdt, **kw).to(tdt)
            want = tref.flash_attention_ref(*xs, **kw)
            worst = max(worst, ulps(got, want))
            if D == 1:   # a one-element row is its own rms: no floor
                worst_row_scale = max(worst_row_scale, ulps(
                    got.reshape(-1, 1, 1, 1), want.reshape(-1, 1, 1, 1)))
    assert worst <= smoke.FLASH_ULP_LIMIT
    if D == 1 and elem == "bf16":
        assert worst_row_scale > smoke.FLASH_ULP_LIMIT


def test_f16_ulps_counts_float16_ulps():
    """chip_smoke.f16_ulps: one float16 ulp is 2^-10 of the value's binade,
    2^-24 below 2^-14 (subnormals); bf16_ulps keeps its 2^-7."""
    smoke = _chip_smoke()
    want = torch.tensor([[1.0, 1.5, 3.0, 0.75]])
    one = torch.tensor([[2.0**-10, 2.0**-10, 2.0**-9, 2.0**-11]])
    assert smoke.f16_ulps(want + one, want) == pytest.approx(1.0)
    assert smoke.bf16_ulps(want + 2**3 * one, want) == pytest.approx(1.0)
    tiny = torch.full((1, 4), 2.0**-20)
    assert smoke.f16_ulps(tiny + 2.0**-24, tiny) == pytest.approx(1.0)


@pytest.mark.parametrize("dtype,dim,route", [
    (torch.bfloat16, 64, "WGMMA"), (torch.bfloat16, 96, "WGMMA"),
    (torch.bfloat16, 128, "WGMMA"), (torch.float32, 96, "WGMMA_F32"),
    (torch.bfloat16, 16, "WGMMA_PADDED"), (torch.bfloat16, 32, "WGMMA_PADDED"),
    (torch.float32, 16, "WGMMA_F32"), (torch.float32, 32, "WGMMA_F32"),
    (torch.float32, 64, "WGMMA_F32"), (torch.float32, 128, "WGMMA_F32"),
    (torch.float32, 4, "WGMMA_F32"), (torch.float32, 100, "WGMMA_F32"),
    (torch.float32, 6, "PADDED"), (torch.float32, 130, "PADDED"),
    (torch.float32, 132, "PADDED"),
    (torch.float16, 128, "WGMMA_F16"), (torch.float16, 64, "WGMMA_F16"),
    (torch.bfloat16, 48, "WGMMA_PADDED"), (torch.float16, 48, "WGMMA_F16"),
    (torch.bfloat16, 80, "WGMMA_PADDED"), (torch.float16, 80, "WGMMA_F16"),
    (torch.bfloat16, 200, "WGMMA_PADDED"), (torch.float16, 200, "WGMMA_F16"),
    (torch.bfloat16, 256, "WGMMA_PADDED"), (torch.float16, 256, "WGMMA_F16"),
    (torch.bfloat16, 20, "WGMMA_LOADED"), (torch.float16, 20, "WGMMA_LOADED"),
    (torch.float32, 48, "WGMMA_F32"), (torch.float32, 80, "WGMMA_F32"),
    (torch.float32, 200, "PADDED"), (torch.float32, 256, "PADDED"),
    (torch.bfloat16, 320, "WIDE"), (torch.float16, 320, "WIDE"),
    (torch.float32, 320, "WIDE")])
def test_routing_table(dtype, dim, route):
    want = getattr(tflash, route)
    assert tflash.route(dtype, dim) == want
    _, q = _pair(np.random.default_rng(0), (1, 8, 4, dim), "f32")
    q = q.to(dtype)
    assert tflash.cuda_route(q, q[:, :, :2].contiguous(),
                             q[:, :, :2].contiguous()) == want
    assert tflash.WGMMA == ("flash_wgmma_kernel", "flash_attention_wgmma")
    assert tflash.WGMMA_F16 == ("flash_wgmma_kernel",
                                "flash_attention_wgmma_f16")
    assert tflash.WGMMA_PADDED == ("flash_wgmma_kernel",
                                   "flash_attention_wgmma_padded")
    assert tflash.WGMMA_F32 == ("flash_wgmma_kernel",
                                "flash_attention_wgmma_f32")
    assert tflash.SIMT == ("flash_kernel", "flash_attention_simt")
    assert set(tflash.LAUNCHES) == {r.counter for r in tflash.ROUTES}


@pytest.mark.parametrize("dtype,dim,route", [
    (torch.bfloat16, 72, "WGMMA_LOADED"), (torch.float16, 72, "WGMMA_LOADED"),
    (torch.bfloat16, 64, "WGMMA_LOADED"), (torch.float16, 128, "WGMMA_LOADED"),
    (torch.float16, 16, "WGMMA_LOADED"), (torch.bfloat16, 256, "WGMMA_LOADED"),
    (torch.float32, 72, "PADDED"), (torch.float32, 64, "SIMT"),
    (torch.float32, 128, "SIMT"), (torch.float32, 100, "PADDED")])
def test_routing_off_16_byte_boundaries(dtype, dim, route):
    """TMA takes 16-byte-aligned tensors only: 16-bit inputs off a
    16-byte boundary take the tensor cores' loaded route at any head dim up
    to 256; float32 off a boundary takes flash_kernel (the float32 kind's
    producer reads 16-byte words), on one the tensor cores."""
    want = getattr(tflash, route)
    assert tflash.route(dtype, dim, aligned=False) == want
    n = 8 * 4 * dim
    flat = torch.zeros(n + 1, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    q = flat[1:].view(1, 8, 4, dim)    # one element past the boundary
    kv = torch.zeros((1, 8, 2, dim), dtype=dtype)
    assert tflash.cuda_route(q, kv, kv) == want
    assert tflash.cuda_route(kv, q[:, :, :2].contiguous(), kv) == \
        tflash.route(dtype, dim)   # a contiguous copy is aligned again


def _off_boundary(shape, dtype, offset):
    """A zero tensor of ``shape`` starting ``offset`` elements past a
    16-byte boundary."""
    flat = torch.zeros(int(np.prod(shape)) + offset, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    return flat[offset:].view(shape)


@pytest.mark.parametrize("offset", range(1, 8))
@pytest.mark.parametrize("which", ["q", "k", "v", "qkv"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_routing_by_each_tensors_offset(dtype, which, offset):
    """Any one of q, k and v off a 16-byte boundary, by any element offset
    1-7, sends a 16-bit call to the loaded route; each tensor's own offset
    decides, and the same values on boundaries take TMA's route."""
    dim = 64
    shapes = {"q": (1, 8, 4, dim), "k": (1, 8, 2, dim), "v": (1, 8, 2, dim)}
    t = {n: _off_boundary(sh, dtype, offset if n in which else 0)
         for n, sh in shapes.items()}
    want = {n: offset if n in which else 0 for n in shapes}
    assert tflash.element_offsets(t["q"], t["k"], t["v"]) == \
        (want["q"], want["k"], want["v"])
    assert tflash.cuda_route(t["q"], t["k"], t["v"]) == tflash.WGMMA_LOADED
    aligned = [x.contiguous().clone() for x in (t["q"], t["k"], t["v"])]
    assert tflash.element_offsets(*aligned) == (0, 0, 0)
    assert tflash.cuda_route(*aligned) == tflash.route(dtype, dim)
    assert tflash.route(dtype, dim) in (tflash.WGMMA, tflash.WGMMA_F16)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_no_16_bit_input_reaches_flash_kernel(dtype, aligned):
    """Every bf16 and float16 head dim up to 256, on or off a 16-byte
    boundary, runs on the tensor cores (flash_wgmma_kernel); past 256,
    flash_wide_kernel; flash_kernel keeps float32 alone: off a boundary,
    or at a head dim that is not a multiple of 4 or is past 128."""
    for dim in range(1, tflash.MAX_PADDED + 1):
        r = tflash.route(dtype, dim, aligned=aligned)
        assert r in tflash.TENSOR_CORE_ROUTES, (dim, r)
        assert r.kernel == "flash_wgmma_kernel"
        assert (r is tflash.WGMMA_LOADED) == (
            not aligned or dim % tflash.WGMMA_DIM_STEP != 0)
    assert tflash.route(dtype, tflash.MAX_PADDED + 1, aligned) == tflash.WIDE
    flash_kernel = {r for r in tflash.ROUTES if r.kernel == "flash_kernel"}
    assert flash_kernel == {tflash.SIMT, tflash.PADDED}
    assert {tflash.route(torch.float32, d, aligned=False)
            for d in range(1, 257)} == flash_kernel
    for d in range(1, 257):
        r = tflash.route(torch.float32, d)
        assert (r is tflash.WGMMA_F32) == (d % 4 == 0 and d <= 128), (d, r)
        assert r is tflash.WGMMA_F32 or r in flash_kernel


def test_cuda_route_refuses_what_the_kernels_do_not_take():
    """The checks a CUDA call runs before it launches (shapes, dtypes,
    layout); what the reference takes (any head dim, float16, mixed
    dtypes, bf16 off 16-byte boundaries) takes a route instead."""
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    assert tflash.cuda_route(*(torch.zeros((1, 8, 2, 48)),) * 3) == \
        tflash.WGMMA_F32
    assert tflash.cuda_route(*(torch.zeros((1, 8, 2, 50)),) * 3) == \
        tflash.PADDED
    with pytest.raises(ValueError, match="head dims"):
        tflash.cuda_route(*(torch.zeros((1, 8, 2, 0)),) * 3)
    with pytest.raises(ValueError, match="must divide"):
        tflash.cuda_route(q, torch.zeros((1, 8, 3, 64), dtype=torch.bfloat16),
                          torch.zeros((1, 8, 3, 64), dtype=torch.bfloat16))
    # Lk != Lq is taken, on either route; k and v of different lengths, a
    # batch or head-dim mismatch, and no key at all are not
    for lk in (4, 1, 1024):
        other = torch.zeros((1, lk, 2, 64), dtype=torch.bfloat16)
        assert tflash.cuda_route(q, other, other) == tflash.WGMMA
        assert tflash.cuda_route(q.float(), other.float(),
                                 other.float()) == tflash.WGMMA_F32
    with pytest.raises(ValueError, match="shape"):
        tflash.cuda_route(q, kv, kv[:, :4].contiguous())
    with pytest.raises(ValueError, match="shape"):
        tflash.cuda_route(q, kv[:, :4].contiguous(), kv)
    with pytest.raises(ValueError, match="shape"):
        tflash.cuda_route(q, *(torch.zeros((2, 8, 2, 64),
                                           dtype=torch.bfloat16),) * 2)
    with pytest.raises(ValueError, match="shape"):
        tflash.cuda_route(q, *(torch.zeros((1, 8, 2, 32),
                                           dtype=torch.bfloat16),) * 2)
    with pytest.raises(ValueError, match="at least one key"):
        tflash.cuda_route(q, kv[:, :0], kv[:, :0])
    # mixed dtypes run the float32 route (fresh casts: on a boundary);
    # float16 the tensor cores' f16 kind; float64 none
    assert tflash.cuda_route(q, kv.float(), kv.float()) == tflash.WGMMA_F32
    assert tflash.cuda_route(q.half(), kv.half(), kv.half()) == \
        tflash.WGMMA_F16
    with pytest.raises(TypeError, match="dtype"):
        tflash.cuda_route(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="contiguous"):
        tflash.cuda_route(q, kv, torch.zeros((1, 2, 8, 64),
                                             dtype=torch.bfloat16).transpose(1, 2))
    flat = torch.zeros(q.numel() + 8, dtype=torch.bfloat16)
    odd = flat[1:1 + q.numel()].view(q.shape)   # 2 bytes past an aligned start
    assert flat.data_ptr() % 16 == 0
    # TMA needs 16-byte boundaries: unaligned bf16 takes the loaded route
    assert tflash.cuda_route(odd, kv, kv) == tflash.WGMMA_LOADED
    # float32 off a boundary takes flash_kernel, which has no alignment rule
    flat32 = torch.zeros(q.numel() + 1)
    odd32 = flat32[1:].view(q.shape)           # 4 bytes past an aligned start
    assert tflash.cuda_route(odd32, kv.float(), kv.float()) == tflash.SIMT
    with pytest.raises(RuntimeError, match="forward-only"):
        tflash.cuda_route(q.float().requires_grad_(), kv.float(), kv.float())


@pytest.mark.parametrize("dts,offset,route", [
    (("f32", "bf16", "bf16"), 0, "WGMMA_F32"),
    (("f32", "bf16", "bf16"), 1, "SIMT"),
    (("bf16", "f32", "f32"), 0, "WGMMA_F32"),
    (("f16", "f32", "bf16"), 0, "WGMMA_F32"),
    (("f32", "f32", "f16"), 0, "WGMMA_F32"),
    (("bf16", "f16", "f16"), 0, "WGMMA_F32")])
def test_mixed_dtypes_reach_the_kernel_in_float32(monkeypatch, dts, offset,
                                                  route):
    """q, k and v of mixed dtypes reach the launch as float32 tensors,
    whichever of them is float32: a 16-bit one is cast into a fresh
    tensor, a float32 one is passed on as it is (so a float32 q off a
    16-byte boundary takes flash_kernel).  The launch is faked, so this
    runs on the CPU; the output takes q's dtype."""
    dtypes = dict(f32=torch.float32, bf16=torch.bfloat16, f16=torch.float16)
    shapes = ((1, 8, 4, 64), (1, 8, 2, 64), (1, 8, 2, 64))
    q, k, v = (torch.zeros(s, dtype=dtypes[d]) for s, d in zip(shapes, dts))
    if offset:
        flat = torch.zeros(q.numel() + offset, dtype=q.dtype)
        assert flat.data_ptr() % 16 == 0
        q = flat[offset:].view(q.shape)
    want = getattr(tflash, route)
    assert tflash.cuda_route(q, k, v) is want
    passed = []

    def fake_ptr(t):
        passed.append(t)
        return 0 if t is None else t.data_ptr()

    class FakeLib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(tflash, "on_cuda", lambda *t: True)
    monkeypatch.setattr(tflash, "stream", lambda t: 0)
    monkeypatch.setattr(tflash, "ptr", fake_ptr)
    monkeypatch.setattr(tflash._build, "load", lambda: FakeLib())
    tflash.reset_launches()
    out = tflash.flash_attention(q, k, v)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert {n: c for n, c in tflash.LAUNCHES.items() if c} == {want.counter: 1}
    assert len(passed) == 4        # q, k, v and the output
    assert all(t.dtype == torch.float32 for t in passed)
    for t, x in zip(passed, (q, k, v)):
        assert (t.data_ptr() == x.data_ptr()) == (x.dtype == torch.float32)
    tflash.reset_launches()


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel runs in chip_smoke.py")
    q = torch.zeros((1, 8, 2, 0), device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        tflash.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 50), device="cuda")
    tflash.reset_launches()
    assert tflash.flash_attention(q, q, q).shape == q.shape   # any head dim
    assert tflash.LAUNCHES[tflash.PADDED.counter] == 1
    with pytest.raises(ValueError, match="cannot force"):
        tflash.flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(),
                               force=tflash.SIMT)
    q = torch.zeros((1, 8, 2, 16), device="cuda", requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tflash.flash_attention(q, q, q)
