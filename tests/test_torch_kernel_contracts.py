"""The reference kernels' whole contracts in the port, plain path, against
repro.kernels.

What the Pallas kernels take beyond what any config reaches: flash
attention at any head dim, in float16 and with q, k, v of mixed dtypes;
the SSD tile and chunked path at any chunk, state and head width with
float16, bf16 or float32 B and C; the gain kernels on float16 phi and g,
on phi and g of different dtypes, and megastep past 12,287 agents.  Each
wrapper's CPU path (its plain version) is held against the Pallas kernel
in interpret mode on the same numpy inputs, at the repo's tolerances
(flash 3e-4 float32 / 3e-2 bf16, SSD tile 1e-4 and chunked 2e-4, gain
statistics 1e-5 of |value| + 1 and gains 1e-5 of their run's largest) and
3e-3 for float16 outputs, rtol = atol; transmit decisions exact.  The
route tables pin the CUDA kernel each new shape, dtype and alignment takes
(the kernels themselves run in chip_smoke.py's contract phase), and
``random.random_bits`` is held to JAX 0.9.0's 64-bit threefry counters
past 2**32 without a large draw.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from jax._src import prng as jprng  # noqa: E402
from repro.kernels import flash_attention as jflash  # noqa: E402
from repro.kernels import gain as jk  # noqa: E402
from repro.kernels import ssd_scan as jss  # noqa: E402

from repro_torch import random as trandom  # noqa: E402
from repro_torch.kernels import flash_attention as tflash  # noqa: E402
from repro_torch.kernels import gain as tk  # noqa: E402
from repro_torch.kernels import ssd_scan as tss  # noqa: E402

JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f16": jnp.float16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16}
FLASH_TOL = {"f32": 3e-4, "bf16": 3e-2, "f16": 3e-3}
F16_TOL = 3e-3
TILE_TOL, CHUNKED_TOL = 1e-4, 2e-4
GAIN_TOL = 1e-5


@pytest.fixture
def rng(request):
    """A generator per test, so inputs do not depend on test order."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _pair(rng, shape, dt, scale=1.0):
    """One random array as (jax, torch), identical values in ``dt``."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    j = jnp.asarray(x).astype(JNP[dt])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dt])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float() if hasattr(got, "float")
                                          else got, np.float32),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# flash attention: any head dim, float16, mixed dtypes
# ---------------------------------------------------------------------------

FLASH_DIMS = (1, 8, 40, 80, 200, 256, 320)
# each (head dim, dtype) takes one mask; over the three dtypes every head
# dim sees all three: causal, windowed, and Lk != Lq (full, so every row
# sees a key)
FLASH_MASKS = (dict(Lq=70, Lk=70, causal=True, window=0),
               dict(Lq=70, Lk=70, causal=True, window=16),
               dict(Lq=70, Lk=40, causal=False, window=0))


def _flash_pair(rng, D, dts, mask, H=4, KVH=2):
    q = _pair(rng, (1, mask["Lq"], H, D), dts[0])
    k = _pair(rng, (1, mask["Lk"], KVH, D), dts[1])
    v = _pair(rng, (1, mask["Lk"], KVH, D), dts[2])
    return q, k, v


@pytest.mark.parametrize("D", FLASH_DIMS)
@pytest.mark.parametrize("i,dt", list(enumerate(("f32", "bf16", "f16"))))
def test_flash_any_head_dim_and_dtype_matches_pallas(rng, D, i, dt):
    mask = FLASH_MASKS[(i + FLASH_DIMS.index(D)) % 3]
    q, k, v = _flash_pair(rng, D, (dt,) * 3, mask)
    kw = dict(causal=mask["causal"], window=mask["window"])
    want = jflash.flash_attention(q[0], k[0], v[0], interpret=True, **kw)
    got = tflash.flash_attention(q[1], k[1], v[1], **kw)
    assert got.dtype == TORCH[dt] and want.dtype == JNP[dt]
    _close(got, want, FLASH_TOL[dt])
    assert tflash.cuda_route(q[1], k[1], v[1]) == tflash.route(TORCH[dt], D)


@pytest.mark.parametrize("dts", [("bf16", "f32", "f32"),
                                 ("f16", "f32", "bf16"),
                                 ("f32", "bf16", "bf16")])
def test_flash_mixed_dtypes_match_pallas(rng, dts):
    """The Pallas kernel casts q, k and v to float32 each; so does the
    port (the float32 route of the head dim), and the output takes q's
    dtype."""
    mask = FLASH_MASKS[1]
    q, k, v = _flash_pair(rng, 40, dts, mask)
    kw = dict(causal=True, window=mask["window"])
    want = jflash.flash_attention(q[0], k[0], v[0], interpret=True, **kw)
    got = tflash.flash_attention(q[1], k[1], v[1], **kw)
    assert got.dtype == TORCH[dts[0]] and want.dtype == JNP[dts[0]]
    _close(got, want, FLASH_TOL[dts[0]])
    assert tflash.compute_dtype(q[1], k[1], v[1]) == torch.float32
    assert tflash.cuda_route(q[1], k[1], v[1]) == tflash.WGMMA_F32


def _aligned_pair(D, dtype, offset):
    """q, k, v of shape (1, 8, 4|2, D) starting ``offset`` elements past a
    16-byte boundary."""
    out = []
    for heads in (4, 2):
        n = 8 * heads * D
        flat = torch.zeros(n + offset, dtype=dtype)
        assert flat.data_ptr() % 16 == 0
        out.append(flat[offset:].view(1, 8, heads, D))
    return out[0], out[1], out[1]


@pytest.mark.parametrize("dtype,D,offset,route", [
    (torch.bfloat16, 64, 0, "WGMMA"), (torch.bfloat16, 64, 1, "WGMMA_LOADED"),
    (torch.bfloat16, 128, 2, "WGMMA_LOADED"), (torch.bfloat16, 96, 0, "WGMMA"),
    (torch.float16, 64, 0, "WGMMA_F16"), (torch.float16, 128, 1, "WGMMA_LOADED"),
    (torch.float16, 16, 0, "WGMMA_F16"), (torch.float32, 128, 1, "SIMT"),
    (torch.float32, 40, 0, "WGMMA_F32"), (torch.float32, 40, 1, "PADDED"),
    (torch.float32, 42, 0, "PADDED"), (torch.float32, 136, 0, "PADDED"),
    (torch.bfloat16, 80, 0, "WGMMA_PADDED"),
    (torch.float16, 1, 0, "WGMMA_LOADED"), (torch.float16, 200, 0, "WGMMA_F16"),
    (torch.bfloat16, 256, 0, "WGMMA_PADDED"), (torch.float32, 257, 0, "WIDE"),
    (torch.float32, 320, 0, "WIDE"), (torch.bfloat16, 512, 0, "WIDE")])
def test_flash_route_table(dtype, D, offset, route):
    q, k, v = _aligned_pair(D, dtype, offset)
    want = getattr(tflash, route)
    assert tflash.cuda_route(q, k, v) == want
    assert tflash.route(dtype, D, aligned=offset == 0) == want
    assert tflash.LAUNCHES.keys() == {r.counter for r in tflash.ROUTES}
    assert tflash.WGMMA_LOADED == ("flash_wgmma_kernel",
                                   "flash_attention_wgmma_loaded")
    assert tflash.PADDED == ("flash_kernel", "flash_attention_padded")
    assert tflash.WIDE == ("flash_wide_kernel", "flash_attention_wide")


# ---------------------------------------------------------------------------
# SSD: any Q, N, P; float16, bf16, float32 and mixed B/C
# ---------------------------------------------------------------------------

SSD_SHAPES = ((256, 192, 6), (256, 128, 64), (96, 256, 130), (32, 6, 3))


def _ssd_tile(rng, Q, N, P, dts, B=1, nc=2, H=3):
    dtx = rng.normal(size=(B, nc, Q, H, P)).astype(np.float32)
    cum = (-np.abs(rng.normal(size=(B, nc, Q, H))).cumsum(axis=2) * 0.01
           ).astype(np.float32)
    b = _pair(rng, (B, nc, Q, N), dts[0], N ** -0.5)
    c = _pair(rng, (B, nc, Q, N), dts[1], N ** -0.5)
    return (jnp.asarray(dtx), torch.from_numpy(dtx)), \
        (jnp.asarray(cum), torch.from_numpy(cum)), b, c


@pytest.mark.parametrize("Q,N,P", SSD_SHAPES)
@pytest.mark.parametrize("dt", ["f16", "bf16", "f32"])
def test_ssd_tile_any_width_and_dtype_matches_pallas(rng, Q, N, P, dt):
    dtx, cum, b, c = _ssd_tile(rng, Q, N, P, (dt, dt))
    yj, sj = jss.ssd_chunk_tiles(dtx[0], cum[0], b[0], c[0], interpret=True)
    y, st = tss.ssd_chunk_tiles(dtx[1], cum[1], b[1], c[1])
    _close(y, yj, TILE_TOL)
    _close(st, sj, TILE_TOL)
    want = tss.SIMT if max(Q, N, P) <= 128 and dt != "f16" else tss.GENERIC
    assert tss.cuda_route(dtx[1], cum[1], b[1], c[1]) == want


def _chunked(rng, L, H, P, N, dts, B=1):
    xh = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(B, L, H))) * 0.05).astype(np.float32)
    a = -np.abs(rng.normal(size=(H,))).astype(np.float32)
    b = _pair(rng, (B, L, N), dts[0], N ** -0.5)
    c = _pair(rng, (B, L, N), dts[1], N ** -0.5)
    return [(jnp.asarray(x), torch.from_numpy(x)) for x in (xh, dt, a)] + [b, c]


@pytest.mark.parametrize("Q,N,P", SSD_SHAPES)
@pytest.mark.parametrize("dt", ["f16", "bf16", "f32"])
def test_ssd_chunked_chunk_256_matches_pallas(rng, Q, N, P, dt):
    """ssd_chunked at chunk 256 (Q = min(256, L)): L = Q + 44 pads the
    last of two chunks, except where Q < 256 (one chunk of L = Q)."""
    L = Q + 44 if Q == 256 else Q
    arrs = _chunked(rng, L, 3, P, N, (dt, dt))
    yj, hj = jss.ssd_chunked_pallas(*(x[0] for x in arrs), chunk=256,
                                    interpret=True)
    y, h = tss.ssd_chunked(*(x[1] for x in arrs), chunk=256)
    _close(y, yj, CHUNKED_TOL)
    _close(h, hj, CHUNKED_TOL)


def test_ssd_mixed_b_and_c_and_float16_output_match_pallas(rng):
    """B bf16 with C float32 (both read in float32, as the Pallas tile's
    astype), and a float16 xh whose y the pass returns in float16."""
    dtx, cum, b, c = _ssd_tile(rng, 96, 40, 12, ("bf16", "f32"))
    yj, sj = jss.ssd_chunk_tiles(dtx[0], cum[0], b[0], c[0], interpret=True)
    y, st = tss.ssd_chunk_tiles(dtx[1], cum[1], b[1], c[1])
    _close(y, yj, TILE_TOL)
    _close(st, sj, TILE_TOL)
    assert tss.cuda_route(dtx[1], cum[1], b[1], c[1]) == tss.SIMT
    arrs = _chunked(rng, 200, 2, 10, 24, ("f16", "f16"))
    arrs[0] = _pair(rng, (1, 200, 2, 10), "f16")
    yj, hj = jss.ssd_chunked_pallas(*(x[0] for x in arrs), chunk=64,
                                    interpret=True)
    y, h = tss.ssd_chunked(*(x[1] for x in arrs), chunk=64)
    assert y.dtype == torch.float16 and yj.dtype == jnp.float16
    _close(y, yj, F16_TOL)
    _close(h, hj, CHUNKED_TOL)


@pytest.mark.parametrize("Q,N,P,dt,offset,route", [
    (128, 128, 64, "bf16", 0, "WGMMA"), (128, 128, 64, "bf16", 1, "SIMT"),
    (128, 16, 64, "f32", 1, "SIMT"), (128, 16, 64, "f32", 0, "WGMMA_N16"),
    (128, 128, 64, "f16", 0, "GENERIC"), (32, 8, 16, "f16", 0, "GENERIC"),
    (256, 192, 6, "f16", 0, "GENERIC"), (256, 128, 64, "bf16", 0, "GENERIC"),
    (96, 256, 130, "f32", 0, "GENERIC"), (32, 6, 3, "f32", 0, "SIMT"),
    (129, 8, 8, "bf16", 0, "GENERIC"), (128, 128, 128, "f32", 0, "SIMT")])
def test_ssd_tile_route_table(Q, N, P, dt, offset, route):
    """Inputs off a 16-byte boundary leave the tensor cores for
    ssd_chunk_kernel; wider tiles and float16 B/C take the generic tile."""
    flat = torch.zeros(Q * N + offset, dtype=TORCH[dt])
    b = flat[offset:].view(1, 1, Q, N)
    dtx, cum = torch.zeros((1, 1, Q, 2, P)), torch.zeros((1, 1, Q, 2))
    want = getattr(tss, route)
    assert tss.cuda_route(dtx, cum, b, b) == want
    assert tss.route(Q, N, P, TORCH[dt], aligned=offset == 0) == want
    assert tss.cuda_route(dtx, cum, b, b, force=tss.GENERIC) == tss.GENERIC
    assert tss.GENERIC == ("ssd_chunk_generic_kernel",
                           "ssd_chunk_tiles_generic")


@pytest.mark.parametrize("Q,N,P,c_dt,y_dt,offset,route", [
    (128, 128, 64, "bf16", "bf16", 0, "WGMMA"),
    (128, 128, 64, "bf16", "f16", 0, "GENERIC"),
    (128, 128, 64, "f16", "bf16", 0, "GENERIC"),
    (128, 128, 64, "bf16", "bf16", 1, "GENERIC"),
    (32, 8, 16, "f32", "f32", 0, "SIMT"), (256, 192, 6, "f16", "f32", 0,
                                           "GENERIC"),
    (128, 6, 64, "f32", "f32", 0, "GENERIC"), (64, 16, 6, "f32", "f32", 0,
                                               "GENERIC"),
    (256, 128, 64, "bf16", "bf16", 0, "GENERIC")])
def test_ssd_state_pass_route_table(Q, N, P, c_dt, y_dt, offset, route):
    flat = torch.zeros(2 * Q * N + offset, dtype=TORCH[c_dt])
    c = flat[offset:].view(1, 2, Q, N)
    args = (torch.zeros((1, 2, Q, 2, P)), torch.zeros((1, 2, 2, N, P)),
            torch.zeros((1, 2, Q, 2)), c, 2 * Q - 3, TORCH[y_dt])
    want = getattr(tss, "STATE_PASS_" + route)
    assert tss.check_state_pass(*args) == want
    assert tss.state_pass_route(Q, N, P, TORCH[c_dt], TORCH[y_dt],
                                aligned=offset == 0) == want
    assert tss.check_state_pass(*args, route=tss.STATE_PASS_GENERIC) == \
        tss.STATE_PASS_GENERIC
    assert tss.STATE_PASS_GENERIC == ("ssd_state_pass_generic_kernel",
                                      "ssd_state_pass_generic")


# ---------------------------------------------------------------------------
# gain kernels: float16, phi and g of mixed dtypes, any agent count
# ---------------------------------------------------------------------------


def _gain_pair(rng, shape, dt):
    x = rng.random(size=shape).astype(np.float32)
    j = jnp.asarray(x).astype(JNP[dt])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dt])


def _close_stats(got, want):
    _close(np.asarray(got) / (np.abs(np.asarray(want)) + 1),
           np.asarray(want) / (np.abs(np.asarray(want)) + 1), GAIN_TOL)


def _close_gains(got, want):
    """Gains of near-cancelling terms: against the run's largest gain."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=-1, keepdims=True) + 1e-30
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=GAIN_TOL)


@pytest.mark.parametrize("dts", [("f16", "f16"), ("bf16", "f32"),
                                 ("f16", "f32")])
def test_gain_matvec_and_practical_gain_take_float16_and_mixed(rng, dts):
    phi = _gain_pair(rng, (100, 24), dts[0])
    g = _pair(rng, (24,), dts[1])
    _close_stats(tk.gain_matvec(phi[1], g[1]),
                 jk.gain_matvec(phi[0], g[0], interpret=True))
    got = tk.practical_gain(phi[1][None], g[1][None], 0.5)
    want = jk.practical_gain(phi[0], g[0], 0.5, interpret=True)
    _close_gains(got, np.asarray(want)[None])
    r = tk.route("gain_matvec", TORCH[dts[0]], TORCH[dts[1]])
    assert r.dtype == (torch.float16 if dts[1] == "f16" else torch.float32)
    assert r.counter == ("gain_matvec_f16" if dts[1] == "f16"
                         else "gain_matvec")


@pytest.mark.parametrize("dts", [("f16", "f16"), ("bf16", "f32")])
def test_gain_family_stats_takes_float16_and_mixed(rng, dts):
    m, T, n = 6, 40, 12
    phi = _gain_pair(rng, (m, T, n), dts[0])
    g = _pair(rng, (m, n), dts[1])
    gj = _pair(rng, (n,), dts[1])
    pm = _pair(rng, (n, n), "f32", n ** -0.5)
    got = tk.gain_family_stats(phi[1], g[1], gj[1], pm[1])
    want = jk.gain_family_stats(phi[0], g[0], gj[0], pm[0], interpret=True)
    _close_stats(got, want)
    _close_stats(tk.gain_family_stats(phi[1], g[1]),
                 jk.gain_family_stats(phi[0], g[0], interpret=True))
    assert tk.route("gain_family_stats", TORCH[dts[0]],
                    TORCH[dts[1]]).counter == (
        "gain_family_stats_f16" if dts == ("f16", "f16")
        else "gain_family_stats")


def _megastep_case(rng, R, m, T, n, dts):
    phi = _gain_pair(rng, (R, m, T, n), dts[0])
    g = _pair(rng, (R, m, n), dts[1])
    w = _pair(rng, (R, n), "f32")
    gj = _pair(rng, (R, n), "f32")
    pm = _pair(rng, (n, n), "f32", n ** -0.5)
    a = rng.integers(0, 2, size=(R, m)).astype(np.float32)
    modes = np.arange(R, dtype=np.float32) % 6
    return phi, g, w, gj, pm, (jnp.asarray(a), torch.from_numpy(a)), modes


@pytest.mark.parametrize("dts", [("f16", "f16"), ("f16", "f32")])
def test_megastep_takes_float16_and_mixed(rng, dts):
    R, m, T, n = 6, 5, 16, 9
    phi, g, w, gj, pm, a, modes = _megastep_case(rng, R, m, T, n, dts)
    stats = np.asarray(jax.vmap(lambda p, gg, j: jk.gain_family_stats(
        p, gg, j, pm[0], interpret=True))(phi[0], g[0], gj[0]))
    prac = -0.5 * stats[..., 0] + 0.25 * stats[..., 1] / T
    thresh = np.median(np.abs(prac), axis=-1).astype(np.float32) * 0.9
    ctl = np.stack([thresh, modes], -1).astype(np.float32)
    got = tk.megastep_call(phi[1], g[1], w[1], torch.from_numpy(ctl), a[1],
                           gj[1], pm[1], eps=0.5)
    want = jk.megastep_call(phi[0], g[0], w[0], jnp.asarray(ctl), a[0],
                            gj[0], pm[0], eps=0.5, interpret=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close_stats(got[0], want[0])
    _close_gains(got[2], want[2])


def test_megastep_past_the_old_agent_cap_matches_pallas(rng):
    """12,288 agents in one run (the port once refused more than 12,287):
    the decisions exactly, weights and gains at the repo's tolerance."""
    R, m, T, n = 1, 12288, 4, 8
    phi, g, w, gj, pm, a, _ = _megastep_case(rng, R, m, T, n, ("f32", "f32"))
    ctl = np.asarray([[0.02, 1.0]], np.float32)        # practical
    got = tk.megastep_call(phi[1], g[1], w[1], torch.from_numpy(ctl), a[1],
                           eps=0.5)
    want = jk.megastep_call(phi[0], g[0], w[0], jnp.asarray(ctl), a[0],
                            eps=0.5, interpret=True)
    alphas = got[1].numpy()
    assert 0 < alphas.sum() < m
    np.testing.assert_array_equal(alphas, np.asarray(want[1]))
    _close_stats(got[0], want[0])
    _close_gains(got[2], want[2])


def test_gain_route_refuses_what_no_kernel_reads():
    with pytest.raises(TypeError, match="dtype"):
        tk.route("gain_matvec", torch.float64, torch.float32)
    assert set(tk.LAUNCHES) == {"gain_matvec", "gain_family_stats",
                                "megastep", "gain_matvec_f16",
                                "gain_family_stats_f16", "megastep_f16"}


# ---------------------------------------------------------------------------
# the probe inputs: every one is taken
# ---------------------------------------------------------------------------


def test_every_probe_input_is_taken():
    """Flash d 40 float16, d 320 float32, d 80 bf16; the SSD tile at Q
    256, N 192, P 6 with float16 B and C, and its pass; float16 phi with
    float32 g: each has a route."""
    for D, dt, want in ((40, torch.float16, tflash.WGMMA_F16),
                        (320, torch.float32, tflash.WIDE),
                        (80, torch.bfloat16, tflash.WGMMA_PADDED)):
        q = torch.zeros((1, 16, 4, D), dtype=dt)
        assert tflash.cuda_route(q, q[:, :, :2].contiguous(),
                                 q[:, :, :2].contiguous()) == want
    Q, N, P = 256, 192, 6
    b = torch.zeros((1, 2, Q, N), dtype=torch.float16)
    y = torch.zeros((1, 2, Q, 3, P))
    cum = torch.zeros((1, 2, Q, 3))
    assert tss.cuda_route(y, cum, b, b) == tss.GENERIC
    assert tss.check_state_pass(y, torch.zeros((1, 2, 3, N, P)), cum, b,
                                2 * Q - 10, torch.float32) == \
        tss.STATE_PASS_GENERIC
    assert tk.route("megastep", torch.float16, torch.float32) == (
        "family_stats_kernel + gate_update_kernel", "megastep",
        torch.float32)


# ---------------------------------------------------------------------------
# JAX 0.9.0's threefry: 64-bit counters
# ---------------------------------------------------------------------------


def _jax_bits(seed, shape, start):
    """JAX's partitionable threefry bits at counters start .. start + n - 1
    (iota_2x32_shape's (hi, lo) words), hashed by threefry2x32_p."""
    key = jax.random.key_data(jax.random.key(seed))
    ctr = np.arange(start, start + int(np.prod(shape)), dtype=np.uint64)
    hi = jnp.asarray((ctr >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    b1, b2 = jprng.threefry2x32_p.bind(key[0], key[1], hi, lo)
    return np.asarray(b1 ^ b2).reshape(shape)


@pytest.mark.parametrize("start", [2**32 - 2, 2**40, 2**64 - 4])
def test_random_bits_past_2_32_take_jax_64_bit_counters(start):
    assert jax.config.jax_threefry_partitionable
    got = trandom.random_bits(trandom.key(7), (4,), start=start)
    np.testing.assert_array_equal(got.numpy(), _jax_bits(7, (4,), start))


def test_random_bits_counters_agree_with_jax_and_raise_past_2_64():
    """The counters below 2**32 are iota_2x32_shape's too (a whole draw
    equals jax.random.bits), and only a draw past 2**64 elements raises,
    as JAX's does."""
    hi, lo = jprng.iota_2x32_shape((3, 5))
    assert not np.asarray(hi).any()
    np.testing.assert_array_equal(np.asarray(lo).ravel(), np.arange(15))
    np.testing.assert_array_equal(
        trandom.random_bits(trandom.key(3), (3, 5)).numpy(),
        np.asarray(jax.random.bits(jax.random.key(3), (3, 5))))
    with pytest.raises(NotImplementedError, match="2 \\*\\* 64"):
        trandom.random_bits(trandom.key(1), (4,), start=2**64 - 3)
