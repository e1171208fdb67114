"""The port's SSD modules, plain path, against repro.

``repro_torch.kernels.ssd_scan.ssd_chunk_tiles`` and ``.ssd_chunked``
(the tile kernel's module; on CPU tensors its plain version) and
``repro_torch.models.ssm.ssd_chunked`` (the plain chunked SSD) are held
against ``repro.kernels.ssd_scan.ssd_chunk_tiles(interpret=True)``,
``ssd_chunked_pallas(interpret=True)`` and ``repro.models.ssm.ssd_chunked``
in the cases of tests/test_kernels.py:196 and :213, at that test's
tolerances (1e-4 for the tile, 2e-4 for the chunked path; rtol = atol).
Both sides get the same numpy inputs.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ssd_scan as jss  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.kernels import ssd_scan as tss  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


def _tile_inputs(rng, B=2, nc=3, Q=32, H=4, P=16, N=8):
    dtx = rng.normal(size=(B, nc, Q, H, P)).astype(np.float32)
    cum = (-np.abs(rng.normal(size=(B, nc, Q, H))).cumsum(axis=2) * 0.1
           ).astype(np.float32)
    bm = rng.normal(size=(B, nc, Q, N)).astype(np.float32)
    cm = rng.normal(size=(B, nc, Q, N)).astype(np.float32)
    return dtx, cum, bm, cm


def test_ssd_chunk_tiles_matches_the_pallas_tile(rng):
    arrs = _tile_inputs(rng)
    y, st = tss.ssd_chunk_tiles(*map(_t, arrs))
    assert y.shape == arrs[0].shape and st.shape == (2, 3, 4, 8, 16)
    assert y.dtype == st.dtype == torch.float32
    yj, sj = jss.ssd_chunk_tiles(*map(jnp.asarray, arrs), interpret=True)
    _close(y, yj, 1e-4)
    _close(st, sj, 1e-4)


def test_ssd_chunk_tiles_takes_bf16_b_and_c(rng):
    """B and C in the model's dtype are computed in float32, like the
    Pallas tile on the same bf16 values."""
    dtx, cum, bm, cm = _tile_inputs(rng)
    bj, cj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (bm, cm))
    bt, ct = (_t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
              for x in (bj, cj))
    y, st = tss.ssd_chunk_tiles(_t(dtx), _t(cum), bt, ct)
    yj, sj = jss.ssd_chunk_tiles(jnp.asarray(dtx), jnp.asarray(cum), bj, cj,
                                 interpret=True)
    _close(y, yj, 1e-4)
    _close(st, sj, 1e-4)


def _chunked_inputs(rng, L, B=2, H=4, P=16, N=8):
    xh = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, L, H))) * 0.1).astype(np.float32)
    a = (-np.abs(rng.normal(size=(H,)))).astype(np.float32)
    bm = rng.normal(size=(B, L, N)).astype(np.float32)
    cm = rng.normal(size=(B, L, N)).astype(np.float32)
    return xh, dt, a, bm, cm


@pytest.mark.parametrize("L,chunk", [(64, 32), (200, 64), (128, 128)])
def test_ssd_chunked_matches_pallas_path_and_reference(rng, L, chunk):
    arrs = _chunked_inputs(rng, L)
    y1, h1 = tss.ssd_chunked(*map(_t, arrs), chunk=chunk)
    y2, h2 = tssm.ssd_chunked(*map(_t, arrs), chunk=chunk)
    jarrs = list(map(jnp.asarray, arrs))
    yp, hp = jss.ssd_chunked_pallas(*jarrs, chunk=chunk, interpret=True)
    yr, hr = jssm.ssd_chunked(*jarrs, chunk=chunk)
    for y, h in ((y1, h1), (y2, h2)):
        assert y.shape == (2, L, 4, 16) and h.shape == (2, 4, 8, 16)
        for yw, hw in ((yp, hp), (yr, hr)):
            _close(y, yw, 2e-4)
            _close(h, hw, 2e-4)


def test_plain_ssd_chunked_with_an_initial_state(rng):
    """Prefill from a carried state: the port's plain chunked SSD against
    the reference's, and against running the two halves in turn."""
    arrs = _chunked_inputs(rng, 96)
    h0 = rng.normal(size=(2, 4, 8, 16)).astype(np.float32)
    y, h = tssm.ssd_chunked(*map(_t, arrs), chunk=32, initial_state=_t(h0))
    yr, hr = jssm.ssd_chunked(*map(jnp.asarray, arrs), chunk=32,
                              initial_state=jnp.asarray(h0))
    _close(y, yr, 2e-4)
    _close(h, hr, 2e-4)
    first = [_t(x[:, :40]) if x.ndim > 1 else _t(x) for x in arrs]
    rest = [_t(x[:, 40:]) if x.ndim > 1 else _t(x) for x in arrs]
    ya, ha = tssm.ssd_chunked(*first, chunk=32, initial_state=_t(h0))
    yb, hb = tssm.ssd_chunked(*rest, chunk=32, initial_state=ha)
    _close(torch.cat([ya, yb], dim=1), y, 2e-4)
    _close(hb, h, 2e-4)


def test_cpu_tensors_never_count_launches(rng):
    tss.reset_launches()
    tss.ssd_chunked(*map(_t, _chunked_inputs(rng, 40)), chunk=16)
    assert tss.LAUNCHES == {"ssd_chunk_tiles_wgmma": 0,
                            "ssd_chunk_tiles_wgmma_n16": 0,
                            "ssd_chunk_tiles_simt": 0,
                            "ssd_chunk_tiles_generic": 0,
                            "ssd_state_pass_wgmma": 0,
                            "ssd_state_pass_simt": 0,
                            "ssd_state_pass_generic": 0}


def test_non_cpu_tensors_raise_instead_of_falling_back():
    x = torch.empty((1, 2, 8, 2, 4), device="meta")
    c = torch.empty((1, 2, 8, 2), device="meta")
    b = torch.empty((1, 2, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tss.ssd_chunk_tiles(x, c, b, b)


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel runs in chip_smoke.py")
    dtx = torch.zeros((1, 1, 8, 2, 256), device="cuda")
    cum = torch.zeros((1, 1, 8, 2), device="cuda")
    b = torch.zeros((1, 1, 8, 4), device="cuda")
    with pytest.raises(ValueError, match="<= 128"):
        tss.ssd_chunk_tiles(dtx, cum, b, b)
    with pytest.raises(RuntimeError, match="forward-only"):
        tss.ssd_chunk_tiles(dtx[..., :4].contiguous().requires_grad_(), cum, b, b)
    # N 16 on the tensor cores: 16-byte-aligned inputs only; a CUDA-core
    # launch asked for at the same shape gives the same values
    dtx, cum, b, c = (t.to("cuda") for t in map(_t, _tile_inputs(
        np.random.default_rng(0), B=1, nc=2, Q=64, H=3, P=64, N=16)))
    flat = torch.zeros(b.numel() + 4, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        tss.ssd_chunk_tiles(dtx, cum, flat[1:1 + b.numel()].view(b.shape), c)
    tss.reset_launches()
    y, st = tss.ssd_chunk_tiles(dtx, cum, b, c)
    y2, st2 = tss.ssd_chunk_tiles(dtx, cum, b, c, force=tss.SIMT)
    assert tss.LAUNCHES["ssd_chunk_tiles_wgmma_n16"] == 1
    assert tss.LAUNCHES["ssd_chunk_tiles_simt"] == 1
    _close(y.cpu(), y2.cpu(), 1e-4)
    _close(st.cpu(), st2.cpu(), 1e-4)


# ---------------------------------------------------------------------------
# The inter-chunk pass and the tensor-core tile's arithmetic
# ---------------------------------------------------------------------------

from repro_torch.kernels import ref as tref  # noqa: E402


def _chunk_prologue(xh, dt, a, b_mat, c_mat, chunk):
    """ssd_chunked's plain prologue: (dtx, cum, B, C) by chunk."""
    B, L, H, P = xh.shape
    N = b_mat.shape[-1]
    Q = min(chunk, L)
    pad = (-L) % Q
    pad_rows = lambda t: torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, pad))
    xh, dt, b_mat, c_mat = map(pad_rows, (xh, dt, b_mat, c_mat))
    nc = xh.shape[1] // Q
    dt_c = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum(dt_c * a, dim=2)
    dtx = dt_c[..., None] * xh.reshape(B, nc, Q, H, P)
    return (dtx, cum, b_mat.reshape(B, nc, Q, N), c_mat.reshape(B, nc, Q, N))


@pytest.mark.parametrize("L,chunk,N,P", [(64, 32, 8, 16), (200, 64, 8, 16),
                                         (128, 128, 8, 16), (200, 128, 128, 64),
                                         (300, 128, 16, 64)])
def test_state_pass_ref_composes_to_the_pallas_path(rng, L, chunk, N, P):
    """ref.ssd_chunk_ref then ref.ssd_state_pass_ref (the two kernels'
    plain versions) give ssd_chunked_pallas and the reference's plain
    chunked SSD, at the chunked path's 2e-4 (tests/test_kernels.py:213)."""
    H = 2 if N == 128 else 4
    arrs = _chunked_inputs(rng, L, B=1, H=H, P=P, N=N)
    dtx, cum, bm, cm = _chunk_prologue(*map(_t, arrs), chunk)
    y_intra, states = tref.ssd_chunk_ref(dtx, cum, bm, cm)
    y, h = tref.ssd_state_pass_ref(y_intra, states, cum, cm, L, torch.float32)
    assert y.shape == (1, L, H, P) and h.shape == (1, H, N, P)
    jarrs = list(map(jnp.asarray, arrs))
    yp, hp = jss.ssd_chunked_pallas(*jarrs, chunk=chunk, interpret=True)
    yr, hr = jssm.ssd_chunked(*jarrs, chunk=chunk)
    for yw, hw in ((yp, hp), (yr, hr)):
        _close(y, yw, 2e-4)
        _close(h, hw, 2e-4)


def _products(a, b, pieces_a, pieces_b, order):
    """sum of a_i @ b_j over the bf16 pieces of a and b with i + j < order:
    products of bf16 values are exact in float32, sums are float32, as in
    wgmma with float32 accumulation."""
    def split(x, k):
        out, r = [], x.float()
        for _ in range(k):
            p = r.bfloat16().float()
            out.append(p)
            r = r - p
        return out
    pa, pb = split(a, pieces_a), split(b, pieces_b)
    return sum(pa[i] @ pb[j] for i in range(pieces_a) for j in range(pieces_b)
               if i + j < order)


def _emulate_tile(dtx, cum, b, c, pieces=3, single=None):
    """ssd_chunk_wgmma_kernel's arithmetic in plain torch (and, at N 16,
    ssd_chunk_wgmma_n16_kernel's).  Every float32 operand enters as
    ``pieces`` bf16 pieces in the products i + j < ``pieces`` (3: six
    products; 2: the hi/lo pair's three); a bf16 B or C enters as it is.
    ``single`` ("dtx" or "decay") rounds that operand of the y product to
    one bf16 instead.  At N 16 the state product has wgmma's 64 rows: B^T,
    then C^T (C sits in B's swizzle atom, columns 16-31), then zeros, and
    the rows past N are dropped."""
    Q, N = dtx.shape[2], b.shape[-1]
    bf16_bc = b.dtype == torch.bfloat16
    x = dtx.float().permute(0, 1, 3, 2, 4)                 # (B, nc, H, Q, P)
    cm = cum.float().permute(0, 1, 3, 2)                   # (B, nc, H, Q)
    kb = 1 if bf16_bc else pieces
    g = _products(c, b.transpose(-1, -2), kb, kb, pieces)   # (B, nc, Q, Q)
    seg = cm[..., :, None] - cm[..., None, :]
    tril = torch.ones((Q, Q), dtype=torch.bool).tril()
    decay = torch.where(tril, torch.exp(torch.where(
        tril, seg, torch.full_like(seg, -1e30))), torch.zeros(()))
    a = g.unsqueeze(2) * decay
    ka = 1 if single == "decay" else pieces
    kx = 1 if single == "dtx" else pieces
    y = _products(a, x, ka, kx, max(ka, kx))
    w = torch.exp(cm[..., -1:] - cm).unsqueeze(-1)
    bt = b.transpose(-1, -2)
    if N == tss.NARROW_N:
        zeros = torch.zeros(bt.shape[:-2] + (64 - 2 * N, Q), dtype=bt.dtype)
        bt = torch.cat([bt, c.transpose(-1, -2), zeros], dim=-2)
    state = _products(bt.unsqueeze(2), w * x, kb, pieces, pieces)[..., :N, :]
    return y.permute(0, 1, 3, 2, 4), state


SLICE_TILE = dict(B=1, nc=2, Q=128, H=2, P=64, N=128)


def _slice_tile(rng, bc_dtype, N=SLICE_TILE["N"]):
    dtx, cum, bm, cm = _tile_inputs(rng, **dict(SLICE_TILE, N=N))
    if bc_dtype == "bf16":
        bm, cm = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                             .astype(jnp.float32)) for x in (bm, cm))
    want = jss.ssd_chunk_tiles(*map(jnp.asarray, (dtx, cum, bm, cm)),
                               interpret=True)
    torch_bc = torch.bfloat16 if bc_dtype == "bf16" else torch.float32
    got_inputs = (_t(dtx), _t(cum), _t(bm).to(torch_bc), _t(cm).to(torch_bc))
    return got_inputs, want


@pytest.mark.parametrize("bc_dtype,N", [("f32", 128), ("bf16", 128),
                                        ("f32", 16), ("bf16", 16)],
                         ids=["f32", "bf16", "f32-n16", "bf16-n16"])
def test_tensor_core_arithmetic_matches_the_pallas_tile(rng, bc_dtype, N):
    """Three bf16 pieces of every float32 operand (six products) keep the
    tensor-core tiles within the tile's 1e-4 of the Pallas tile at the
    serving slices' widths (Q=128, P=64; N=128 mamba2's, N=16 jamba's with
    the M-64 state product)."""
    inputs, (yj, sj) = _slice_tile(rng, bc_dtype, N)
    y, st = _emulate_tile(*inputs)
    assert st.shape == sj.shape
    _close(y, yj, 1e-4)
    _close(st, sj, 1e-4)


@pytest.mark.parametrize("variant", ["hi_lo", "single_dtx", "single_decay"])
def test_fewer_pieces_leave_the_tile_tolerance(rng, variant):
    """A hi/lo pair (two pieces, three products), or a single bf16 dtx or
    G * decay in the y product, moves y beyond 1e-4 of the Pallas tile on
    the same bf16 B/C inputs: the sums cancel, so their rounding shows."""
    inputs, (yj, _) = _slice_tile(rng, "bf16")
    kw = dict(pieces=2) if variant == "hi_lo" else dict(
        single=variant.split("_")[1])
    y, _ = _emulate_tile(*inputs, **kw)
    with pytest.raises(AssertionError):
        _close(y, yj, 1e-4)


def _emulate_state_pass(y_intra, states, cum, c, length, pieces):
    """ssd_state_pass_wgmma_kernel's arithmetic in plain torch: h carried in
    float32 as the plain version carries it (addcmul), C . h_{c-1} as the
    products of bf16 pieces with a + b < ``pieces`` (h in ``pieces``; a
    float32 C in as many, a bf16 C as it is), the smaller products summed
    first and the main one (piece 0 x piece 0) added last, then y_intra +
    exp(cum) (C . h)."""
    B, nc, Q, H, P = y_intra.shape
    cum = cum.float()
    decay = torch.exp(cum[:, :, -1, :])[..., None, None]
    h = torch.zeros_like(states[:, 0])
    h_before = torch.empty_like(states)
    for ci in range(nc):
        h_before[:, ci] = h
        h = torch.addcmul(states[:, ci], decay[:, ci], h)

    def split(x, k):
        out, r = [], x.float()
        for _ in range(k):
            out.append(r.bfloat16().float())
            r = r - out[-1]
        return out
    kc = 1 if c.dtype == torch.bfloat16 else pieces
    cp, hp = split(c, kc), split(h_before, pieces)
    cross = torch.zeros_like(y_intra)
    for order in range(pieces - 1, 0, -1):
        for a in range(min(order + 1, kc)):
            cross = cross + torch.einsum("bcin,bchnp->bcihp", cp[a],
                                         hp[order - a])
    main = torch.einsum("bcin,bchnp->bcihp", cp[0], hp[0])
    y = y_intra + torch.exp(cum)[..., None] * (cross + main)
    return y.reshape(B, nc * Q, H, P)[:, :length], h


PASS_PIECES = {"bf16": 2, "f32": 3}   # the kernel's pieces of h, by C's dtype


def _tensor_core_chunked(rng, L, c_dtype, pieces, B=1):
    """The tensor-core path's arithmetic (the tile's emulation, then the
    pass's) and ssd_chunked_pallas on the same inputs at mamba2's widths
    (Q 128, N 128, P 64, 4 heads): B and C given to both as bf16 values
    for a bf16 C."""
    arrs = list(_chunked_inputs(rng, L, B=B, H=4, P=64, N=128))
    if c_dtype == "bf16":
        arrs[3], arrs[4] = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                       .astype(jnp.float32))
                            for x in arrs[3:])
    want = jss.ssd_chunked_pallas(*map(jnp.asarray, arrs), chunk=128,
                                  interpret=True)
    dtx, cum, bm, cm = _chunk_prologue(*map(_t, arrs), 128)
    if c_dtype == "bf16":
        bm, cm = bm.bfloat16(), cm.bfloat16()
    y_intra, states = _emulate_tile(dtx, cum, bm, cm)
    return _emulate_state_pass(y_intra, states, cum, cm, L, pieces), want


@pytest.mark.parametrize("L", [512, 500])
@pytest.mark.parametrize("c_dtype", ["bf16", "f32"])
def test_tensor_core_pass_arithmetic_matches_the_pallas_path(rng, c_dtype, L):
    """The tensor-core tile and pass together, in the kernels' arithmetic,
    stay within the chunked path's 2e-4 of ssd_chunked_pallas, 4 chunks
    (500: a padded last chunk).  With bf16 C a hi/lo pair of h (two
    products) is enough, so the kernel uses two pieces; float32 C needs
    three of each (six products; see the next test)."""
    (y, h), (yj, hj) = _tensor_core_chunked(rng, L, c_dtype,
                                            PASS_PIECES[c_dtype])
    assert y.shape == (1, L, 4, 64) and h.shape == (1, 4, 128, 64)
    _close(y, yj, 2e-4)
    _close(h, hj, 2e-4)


# jamba's SSM: state width N 16 (one k16 step of the pass's product, 32-byte
# rows of a bf16 C), head dim P 64, chunk 128
JAMBA_SSM = dict(N=16, P=64, chunk=128)


@pytest.mark.parametrize("L", [384, 300])
def test_ssd_chunked_at_jamba_state_width_matches_pallas(rng, L):
    """The kernel module's ssd_chunked (on the CPU: the tile's and the
    pass's plain versions) and the plain chunked SSD at N 16 against
    ssd_chunked_pallas (interpret mode) and the reference's plain SSD, at
    the chunked path's 2e-4; on the card the tile and the pass both take
    their tensor-core routes there."""
    N, P, chunk = JAMBA_SSM["N"], JAMBA_SSM["P"], JAMBA_SSM["chunk"]
    for dtype in (torch.bfloat16, torch.float32):
        assert tss.route(chunk, N, P, dtype) == tss.WGMMA_N16
    assert tss.state_pass_route(chunk, N, P, torch.bfloat16) == \
        tss.STATE_PASS_WGMMA
    arrs = _chunked_inputs(rng, L, B=1, H=4, P=P, N=N)
    jarrs = list(map(jnp.asarray, arrs))
    yp, hp = jss.ssd_chunked_pallas(*jarrs, chunk=chunk, interpret=True)
    yr, hr = jssm.ssd_chunked(*jarrs, chunk=chunk)
    for fn in (tss.ssd_chunked, tssm.ssd_chunked):
        y, h = fn(*map(_t, arrs), chunk=chunk)
        assert y.shape == (1, L, 4, P) and h.shape == (1, 4, N, P)
        for yw, hw in ((yp, hp), (yr, hr)):
            _close(y, yw, 2e-4)
            _close(h, hw, 2e-4)


@pytest.mark.parametrize("c_dtype", ["bf16", "f32"])
def test_tensor_core_pass_at_jamba_state_width(rng, c_dtype):
    """The tensor-core pass's arithmetic (``_emulate_state_pass``, its
    pieces by C's dtype) after the tensor-core tile's (``_emulate_tile``,
    the M-64 state product), at N 16 over 3 chunks with a padded last one:
    within the chunked path's 2e-4 of ssd_chunked_pallas."""
    L, N, P, chunk = 300, JAMBA_SSM["N"], JAMBA_SSM["P"], JAMBA_SSM["chunk"]
    arrs = list(_chunked_inputs(rng, L, B=1, H=4, P=P, N=N))
    if c_dtype == "bf16":
        arrs[3], arrs[4] = (np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                                       .astype(jnp.float32))
                            for x in arrs[3:])
    yj, hj = jss.ssd_chunked_pallas(*map(jnp.asarray, arrs), chunk=chunk,
                                    interpret=True)
    dtx, cum, bm, cm = _chunk_prologue(*map(_t, arrs), chunk)
    if c_dtype == "bf16":
        bm, cm = bm.bfloat16(), cm.bfloat16()
    y_intra, states = _emulate_tile(dtx, cum, bm, cm)
    y, h = _emulate_state_pass(y_intra, states, cum, cm, L,
                               PASS_PIECES[c_dtype])
    _close(y, yj, 2e-4)
    _close(h, hj, 2e-4)


@pytest.mark.parametrize("c_dtype,pieces", [("f32", 2), ("bf16", 1)])
def test_fewer_pass_pieces_leave_the_chunked_tolerance(rng, c_dtype, pieces):
    """A hi/lo pair of float32 C and h (three products), or a single bf16
    h with bf16 C, moves y beyond 2e-4 of ssd_chunked_pallas over eight
    sequences of 500 tokens.  On one sequence the pair's error is 0.18-1.33
    of the tolerance (3 of 16 seeds over it), three pieces' under 0.1
    (tools/ssd_pass_pieces.py)."""
    (y, _), (yj, _) = _tensor_core_chunked(rng, 500, c_dtype, pieces, B=8)
    with pytest.raises(AssertionError):
        _close(y, yj, 2e-4)


@pytest.mark.parametrize("Q,N,P,dtype,route", [
    (128, 128, 64, torch.bfloat16, "WGMMA"), (128, 128, 64, torch.float32, "WGMMA"),
    (64, 64, 64, torch.bfloat16, "WGMMA"), (64, 128, 128, torch.float32, "WGMMA"),
    (128, 128, 128, torch.bfloat16, "WGMMA"), (128, 128, 128, torch.float32, "SIMT"),
    (32, 8, 16, torch.float32, "SIMT"), (128, 96, 64, torch.bfloat16, "SIMT"),
    (96, 128, 64, torch.bfloat16, "SIMT"), (128, 128, 32, torch.float32, "SIMT"),
    (128, 16, 64, torch.bfloat16, "WGMMA_N16"),
    (128, 16, 64, torch.float32, "WGMMA_N16"),
    (64, 16, 64, torch.bfloat16, "WGMMA_N16"),
    (128, 16, 128, torch.float32, "WGMMA_N16"),
    (32, 16, 16, torch.float32, "SIMT"), (128, 16, 32, torch.bfloat16, "SIMT"),
    (96, 16, 64, torch.bfloat16, "SIMT")])
def test_routing_table(Q, N, P, dtype, route):
    want = getattr(tss, route)
    assert tss.route(Q, N, P, dtype) == want
    dtx = torch.zeros((1, 1, Q, 2, P))
    cum = torch.zeros((1, 1, Q, 2))
    b = torch.zeros((1, 1, Q, N), dtype=dtype)
    assert tss.cuda_route(dtx, cum, b, b) == want
    assert tss.WGMMA == ("ssd_chunk_wgmma_kernel", "ssd_chunk_tiles_wgmma")
    assert tss.WGMMA_N16 == ("ssd_chunk_wgmma_n16_kernel",
                             "ssd_chunk_tiles_wgmma_n16")
    assert tss.SIMT == ("ssd_chunk_kernel", "ssd_chunk_tiles_simt")
    assert tss.STATE_PASS_WGMMA == ("ssd_state_pass_wgmma_kernel",
                                    "ssd_state_pass_wgmma")
    assert tss.STATE_PASS_SIMT == ("ssd_state_pass_kernel",
                                   "ssd_state_pass_simt")
    assert set(tss.LAUNCHES) == {tss.WGMMA.counter, tss.WGMMA_N16.counter,
                                 tss.SIMT.counter, tss.GENERIC.counter,
                                 tss.STATE_PASS_WGMMA.counter,
                                 tss.STATE_PASS_SIMT.counter,
                                 tss.STATE_PASS_GENERIC.counter}


def test_cuda_route_refuses_what_the_tiles_do_not_take():
    """The checks a CUDA tile call runs before it launches: sizes, dtypes
    and layout; what the reference takes (wider tiles, float16 or mixed
    B/C, inputs off 16-byte boundaries) takes a route instead."""
    dtx = torch.zeros((1, 1, 64, 2, 64))
    cum = torch.zeros((1, 1, 64, 2))
    b = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16)
    assert tss.cuda_route(torch.zeros((1, 1, 64, 2, 256)), cum, b, b) == \
        tss.GENERIC
    with pytest.raises(ValueError, match=">= 1"):
        tss.cuda_route(torch.zeros((1, 1, 64, 2, 0)), cum, b, b)
    assert tss.cuda_route(dtx, cum, b.half(), b.half()) == tss.GENERIC
    assert tss.cuda_route(dtx, cum, b, b.float()) == tss.WGMMA   # float32 B/C
    with pytest.raises(TypeError, match="dtype"):
        tss.cuda_route(dtx, cum, b.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        tss.cuda_route(dtx.transpose(2, 3).contiguous().transpose(2, 3),
                       cum, b, b)
    flat = torch.zeros(b.numel() + 8, dtype=torch.bfloat16)
    odd = flat[1:1 + b.numel()].view(b.shape)   # 2 bytes past an aligned start
    assert flat.data_ptr() % 16 == 0
    assert tss.cuda_route(dtx, cum, odd, b) == tss.SIMT   # no TMA-side rule
    with pytest.raises(RuntimeError, match="forward-only"):
        tss.cuda_route(dtx.requires_grad_(), cum, b, b)


@pytest.mark.parametrize("N,tc", [(16, "WGMMA_N16"), (64, "WGMMA")])
def test_cuda_route_takes_a_forced_cuda_core_route(N, tc):
    """A tile call may ask for the CUDA-core kernel on any shape (the smoke
    times it beside the tensor cores), and for a tensor-core kernel only
    on its own shapes."""
    dtx = torch.zeros((1, 1, 128, 2, 64))
    cum = torch.zeros((1, 1, 128, 2))
    b = torch.zeros((1, 1, 128, N), dtype=torch.bfloat16)
    assert tss.cuda_route(dtx, cum, b, b) == getattr(tss, tc)
    assert tss.cuda_route(dtx, cum, b, b, force=tss.SIMT) == tss.SIMT
    other = tss.WGMMA if tc == "WGMMA_N16" else tss.WGMMA_N16
    with pytest.raises(ValueError, match="does not take"):
        tss.cuda_route(dtx, cum, b, b, force=other)


def test_state_pass_checks_refuse_what_it_does_not_take():
    """The checks a CUDA state-pass call runs before it launches; what the
    reference takes (P not a multiple of 4, rows of C not 16-byte
    multiples, float16 output) takes the generic route instead."""
    y = torch.zeros((1, 2, 32, 2, 16))
    s = torch.zeros((1, 2, 2, 8, 16))
    cum = torch.zeros((1, 2, 32, 2))
    c = torch.zeros((1, 2, 32, 8))
    assert (tss.check_state_pass(y, s, cum, c, 60, torch.bfloat16)
            == tss.STATE_PASS_SIMT)
    with pytest.raises(ValueError, match="does not take"):
        tss.check_state_pass(y, s, cum, c, 60, torch.float32,
                             route=tss.STATE_PASS_WGMMA)
    assert tss.check_state_pass(torch.zeros((1, 2, 32, 2, 6)),
                                torch.zeros((1, 2, 2, 8, 6)), cum, c, 60,
                                torch.float32) == tss.STATE_PASS_GENERIC
    assert tss.check_state_pass(y, torch.zeros((1, 2, 2, 6, 16)), cum,
                                torch.zeros((1, 2, 32, 6)), 60,
                                torch.float32) == tss.STATE_PASS_GENERIC
    with pytest.raises(ValueError, match="length"):
        tss.check_state_pass(y, s, cum, c, 65, torch.float32)
    assert tss.check_state_pass(y, s, cum, c, 60, torch.float16) == \
        tss.STATE_PASS_GENERIC
    with pytest.raises(TypeError, match="output dtype"):
        tss.check_state_pass(y, s, cum, c, 60, torch.float64)
    with pytest.raises(ValueError, match="shape"):
        tss.check_state_pass(y, s[:, :1].contiguous(), cum, c, 60,
                             torch.float32)
    with pytest.raises(RuntimeError, match="forward-only"):
        tss.check_state_pass(y.requires_grad_(), s, cum, c, 60, torch.float32)


def test_cpu_tile_and_state_pass_count_no_launches(rng):
    tss.reset_launches()
    dtx, cum, bm, cm = map(_t, _tile_inputs(rng))
    y, st = tss.ssd_chunk_tiles(dtx, cum, bm, cm)
    yo, h = tss.ssd_state_pass(y, st, cum, cm, 90, torch.float32)
    assert yo.shape == (2, 90, 4, 16) and h.shape == (2, 4, 8, 16)
    assert set(tss.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("Q,N,P,dtype,route", [
    (128, 128, 64, torch.bfloat16, "WGMMA"), (128, 128, 64, torch.float32, "WGMMA"),
    (64, 128, 32, torch.bfloat16, "WGMMA"), (64, 16, 96, torch.float32, "WGMMA"),
    (128, 48, 128, torch.bfloat16, "WGMMA"), (128, 128, 16, torch.float32, "SIMT"),
    (32, 8, 16, torch.float32, "SIMT"), (96, 128, 64, torch.bfloat16, "SIMT"),
    (128, 8, 64, torch.bfloat16, "SIMT"), (128, 120, 64, torch.float32, "SIMT"),
    (64, 128, 36, torch.float32, "SIMT"), (128, 16, 64, torch.bfloat16, "WGMMA"),
    (128, 16, 64, torch.float32, "WGMMA")])
def test_state_pass_routing_table(Q, N, P, dtype, route):
    """The tensor-core pass takes Q 64/128, N a multiple of 16 and P a
    multiple of the 32-column slice, in either dtype of C; every other
    shape the pass takes stays on the CUDA-core kernel, which can also be
    asked for on any shape (the smoke times the two side by side)."""
    want = getattr(tss, "STATE_PASS_" + route)
    assert tss.state_pass_route(Q, N, P, dtype) == want
    args = (torch.zeros((1, 2, Q, 2, P)), torch.zeros((1, 2, 2, N, P)),
            torch.zeros((1, 2, Q, 2)), torch.zeros((1, 2, Q, N), dtype=dtype),
            2 * Q - 5, torch.bfloat16)
    assert tss.check_state_pass(*args) == want
    assert tss.check_state_pass(*args, route=tss.STATE_PASS_SIMT) == \
        tss.STATE_PASS_SIMT
    assert tss.PASS_SLICE == 32


@pytest.mark.parametrize("Q,N,P", [(128, 256, 64), (256, 128, 64),
                                   (128, 128, 30)])
def test_state_pass_route_refuses_what_neither_kernel_takes(Q, N, P):
    """Shapes neither fixed-shape pass takes go to the generic pass, and
    only a dtype no kernel reads is refused."""
    assert tss.state_pass_route(Q, N, P, torch.bfloat16) == \
        tss.STATE_PASS_GENERIC
    with pytest.raises(TypeError, match="c_mat dtype"):
        tss.state_pass_route(Q, N, P, torch.float64)


@pytest.mark.cuda
def test_cuda_state_pass_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel runs in chip_smoke.py")
    y = torch.zeros((1, 2, 32, 2, 6), device="cuda")
    s = torch.zeros((1, 2, 2, 8, 6), device="cuda")
    cum = torch.zeros((1, 2, 32, 2), device="cuda")
    c = torch.zeros((1, 2, 32, 8), device="cuda")
    tss.reset_launches()
    tss.ssd_state_pass(y, s, cum, c, 60, torch.float32)   # P 6: generic
    assert tss.LAUNCHES[tss.STATE_PASS_GENERIC.counter] == 1
    with pytest.raises(ValueError, match="length"):
        tss.ssd_state_pass(y, s, cum, c, 65, torch.float32)
    with pytest.raises(ValueError, match="does not take"):
        tss.ssd_state_pass(y[..., :4].contiguous(), s[..., :4].contiguous(),
                           cum, c, 60, torch.float32,
                           route=tss.STATE_PASS_WGMMA)


def test_tile_with_dtx_on_load_refuses_what_it_does_not_take(rng):
    """ssd_chunk_tiles_xdt is the tensor-core route's entry with dtx formed
    on load: CUDA tensors only (on the CPU ssd_chunked forms dtx and runs
    the plain tile), xh in the dtype of B and C, a shape the route takes."""
    xh = torch.zeros((1, 1, 64, 2, 64), dtype=torch.bfloat16)
    dt = torch.zeros((1, 1, 64, 2))
    b = torch.zeros((1, 1, 64, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tss.ssd_chunk_tiles_xdt(xh, dt, dt, b, b)
    m = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tss.ssd_chunk_tiles_xdt(m(xh), m(dt), m(dt), m(b), m(b))
    tss.reset_launches()
    arrs = _chunked_inputs(rng, 96, B=1, H=2, P=64, N=64)
    y, h = tss.ssd_chunked(*map(_t, arrs), chunk=64)
    assert y.shape == (1, 96, 2, 64) and set(tss.LAUNCHES.values()) == {0}
