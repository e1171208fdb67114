"""The port's block-override surface against the reference's.

``repro_torch.kernels.gain.env_blocks`` / ``_block`` parse
``REPRO_TORCH_KERNEL_BLOCKS`` as ``repro.kernels.gain.env_blocks`` /
``_block`` parse ``REPRO_KERNEL_BLOCKS`` (tests/test_bugfix_batch.py,
tests/test_kernels.py::test_kernel_blocks_env_override): the same
``name=int`` pairs give the same maps for the names both packages share,
the same malformed values raise, and a per-call value beats the env value,
which beats the default.  Each package reads only its own variable.  The
port's names are the run-time parameters of its family kernel
(``block_m``, ``megastep_block_m``, ``family_block_t``) and of its matvec
(``block_t``, rows per T-tile: a pure function of T, n, dtype and
``block_t``, ``matvec_geometry``); the reference's other names
(``block_n``, ``family_block_n``: a row's dot product is never split) are
refused.  On CPU tensors the wrappers run their plain versions, so a
retiled call still equals the Pallas kernel in interpret mode at the
reference's own tiling, within the 2e-4 scale-normalized tolerance of
tests/test_torch_kernels.py (decisions exact), and the matvec within
tests/parity.py's 1e-5.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import gain as jk  # noqa: E402
from parity import WEIGHT_TOL  # noqa: E402

from repro_torch.kernels import gain as tk  # noqa: E402

TOL = 2e-4
SHARED = ("block_m", "block_t", "family_block_t", "megastep_block_m")
REFERENCE_ONLY = ("block_n", "family_block_n")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    monkeypatch.delenv(jk._BLOCKS_ENV, raising=False)
    monkeypatch.delenv(tk.BLOCKS_ENV, raising=False)


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def test_names_are_the_shared_run_time_parameters():
    assert tk.BLOCKS_ENV == "REPRO_TORCH_KERNEL_BLOCKS"
    assert set(tk.KNOWN_BLOCKS) == set(SHARED)
    assert set(SHARED) | set(REFERENCE_ONLY) == set(jk._KNOWN_BLOCKS)


@pytest.mark.parametrize("spec", [
    "", "block_m=2", " family_block_t=16 , megastep_block_m=8",
    "block_m=3,block_m=5", "family_block_t=-4,", ",,block_m= 7 ",
    "block_t=64", "block_t = 8, family_block_t=32", "block_t=0",
])
def test_same_spec_parses_to_the_same_map(monkeypatch, spec):
    monkeypatch.setenv(jk._BLOCKS_ENV, spec)
    monkeypatch.setenv(tk.BLOCKS_ENV, spec)
    assert tk.env_blocks() == jk.env_blocks()


@pytest.mark.parametrize("spec,match", [
    ("16", "name=int"),
    ("block_m", "name=int"),
    ("block_m=sixty-four", "sixty-four"),
    ("family_block_t=1.5", "is not an integer"),
    ("megastep_blockm=64", "unknown block name"),
    ("block_t=2x", "is not an integer"),
    ("block_t", "name=int"),
])
def test_same_malformed_spec_raises(monkeypatch, spec, match):
    monkeypatch.setenv(jk._BLOCKS_ENV, spec)
    monkeypatch.setenv(tk.BLOCKS_ENV, spec)
    with pytest.raises(ValueError, match=match):
        jk.env_blocks()
    with pytest.raises(ValueError, match=match) as e:
        tk.env_blocks()
    # each names its own variable; an unknown name lists the valid ones
    assert tk.BLOCKS_ENV in str(e.value)
    if match == "unknown block name":
        assert all(name in str(e.value) for name in SHARED)


@pytest.mark.parametrize("name", REFERENCE_ONLY)
def test_reference_only_names_are_refused(monkeypatch, name):
    monkeypatch.setenv(jk._BLOCKS_ENV, f"{name}=8")
    monkeypatch.setenv(tk.BLOCKS_ENV, f"{name}=8")
    assert jk.env_blocks() == {name: 8}
    with pytest.raises(ValueError, match="unknown block name"):
        tk.env_blocks()


def test_variables_do_not_cross(monkeypatch):
    monkeypatch.setenv(jk._BLOCKS_ENV, "block_m=2,bogus=1")
    assert tk.env_blocks() == {}
    assert tk.family_geometry(100, 30, True) == tk.family_geometry(
        100, 30, True, block_m=tk.BLOCK_M, block_t=tk.FAMILY_BLOCK_T)
    monkeypatch.delenv(jk._BLOCKS_ENV)
    monkeypatch.setenv(tk.BLOCKS_ENV, "block_m=2,family_block_t=16")
    assert jk.env_blocks() == {}
    assert jk._block("block_m", None, jk.BLOCK_M) == jk.BLOCK_M


def test_precedence_per_call_then_env_then_default(monkeypatch):
    geo = tk.family_geometry
    assert geo(128, 8, False)[:2] == (tk.BLOCK_M, tk.FAMILY_BLOCK_T)
    assert geo(128, 8, False, megastep=True).block_m == tk.MEGASTEP_BLOCK_M
    monkeypatch.setenv(tk.BLOCKS_ENV, "block_m=3,family_block_t=16")
    assert geo(128, 8, False)[:2] == (3, 16)
    # megastep reads megastep_block_m, not block_m
    assert geo(128, 8, False, megastep=True)[:2] == (tk.MEGASTEP_BLOCK_M, 16)
    monkeypatch.setenv(tk.BLOCKS_ENV, "megastep_block_m=5,family_block_t=16")
    assert geo(128, 8, False, megastep=True)[:2] == (5, 16)
    assert geo(128, 8, False, megastep=True, block_m=2, block_t=40)[:2] == (2, 40)
    assert geo(128, 8, False, block_m=7)[:2] == (7, 16)
    # the reference's own precedence, for comparison
    monkeypatch.setenv(jk._BLOCKS_ENV, "megastep_block_m=5")
    assert jk._block("megastep_block_m", None, 32) == 5
    assert jk._block("megastep_block_m", 2, 32) == 2


@pytest.mark.parametrize("T,n,with_model,bt,want", [
    (128, 256, True, 128, (1, 4)), (128, 256, True, 64, (2, 4)),
    (1024, 512, True, 128, (8, 8)), (1000, 6, True, 128, (8, 1)),
    (1000, 6, False, 64, (16, 0)), (8, 10, True, 64, (1, 1)),
    (0, 10, True, 64, (1, 1)), (37, 65, True, 5, (8, 2)),
])
def test_family_geometry(T, n, with_model, bt, want):
    g = tk.family_geometry(T, n, with_model, block_t=bt)
    assert (g.tiles, g.chunks) == want
    assert g.width == g.tiles + g.chunks + 2
    assert g.tiles * bt >= T and (g.tiles - 1) * bt < max(T, 1)


@pytest.mark.parametrize("call", ["per_call", "env"])
def test_blocks_are_checked_before_the_cpu_branch(monkeypatch, call):
    phi, g = torch.zeros((2, 3, 5, 4)), torch.zeros((2, 3, 4))
    w, ctl, ar = torch.zeros((2, 4)), torch.zeros((2, 2)), torch.zeros((2, 3))
    bad = [dict(block_t=0), dict(block_m=-1), dict(block_m="4")]
    if call == "env":
        for spec in ("family_block_t=0", "megastep_block_m=-2",
                     "family_block_t=x", "block_n=4", "block_t=0",
                     "block_t=-3"):
            monkeypatch.setenv(tk.BLOCKS_ENV, spec)
            with pytest.raises(ValueError):
                if spec.startswith("megastep"):
                    tk.megastep_call(phi, g, w, ctl, ar, eps=0.1)
                elif spec.startswith("block_t"):
                    tk.gain_matvec(phi, g)
                else:
                    tk.gain_family_stats(phi, g)
            if spec.startswith("block_t"):
                with pytest.raises(ValueError):
                    tk.practical_gain(phi, g)
        return
    for kw in bad:
        with pytest.raises(ValueError):
            tk.gain_family_stats(phi, g, **kw)
        with pytest.raises(ValueError):
            tk.megastep_call(phi, g, w, ctl, ar, eps=0.1, **kw)
    for bt in (0, -1, "4", 2.0):
        with pytest.raises(ValueError):
            tk.gain_matvec(phi, g, block_t=bt)
        with pytest.raises(ValueError):
            tk.practical_gain(phi, g, block_t=bt)


def _jt(rng, shape):
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("bm,bt", [(2, 16), (3, 5)])
def test_retiled_family_equals_the_interpret_kernel(monkeypatch, rng, bm, bt):
    """The reference's retiling case (m 5, T 37, n 23), the port retiled by
    env and per call, the Pallas kernel retiled per call."""
    m, T, n = 5, 37, 23
    jphi, tphi = _jt(rng, (m, T, n))
    jg, tg = _jt(rng, (m, n))
    jgj, tgj = _jt(rng, (n,))
    jpm, tpm = _jt(rng, (n, n))
    want = jk.gain_family_stats(jphi, jg, jgj, jpm, interpret=True,
                                block_m=bm, block_t=bt, block_n=8)
    _close(tk.gain_family_stats(tphi, tg, tgj, tpm, block_m=bm, block_t=bt),
           want)
    monkeypatch.setenv(tk.BLOCKS_ENV, f"block_m={bm},family_block_t={bt}")
    _close(tk.gain_family_stats(tphi, tg, tgj, tpm), want)
    _close(tk.gain_family_stats(tphi, tg), np.asarray(want)[:, :2])


def test_retiled_megastep_equals_the_interpret_kernel(monkeypatch, rng):
    R, m, T, n = 2, 5, 12, 9
    jphi, tphi = _jt(rng, (R, m, T, n))
    jg, tg = _jt(rng, (R, m, n))
    jw, tw = _jt(rng, (R, n))
    jgj, tgj = _jt(rng, (R, n))
    jpm, tpm = _jt(rng, (n, n))
    ar = (rng.random((R, m)) < 0.5).astype(np.float32)
    ctl = np.array([[0.05, 1.0], [0.05, 0.0]], np.float32)
    want = jk.megastep_call(jphi, jg, jw, jnp.asarray(ctl), jnp.asarray(ar),
                            jgj, jpm, eps=0.5, interpret=True, block_m=2,
                            block_t=5, block_n=4)
    monkeypatch.setenv(tk.BLOCKS_ENV, "megastep_block_m=3,family_block_t=7")
    for kw in ({}, dict(block_m=2, block_t=5)):
        got = tk.megastep_call(tphi, tg, tw, torch.from_numpy(ctl),
                               torch.from_numpy(ar), tgj, tpm, eps=0.5, **kw)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[0], want[0])
        _close(got[2], want[2])


# ---------------------------------------------------------------------------
# gain_matvec's T-tile (block_t)
# ---------------------------------------------------------------------------


def test_matvec_precedence_per_call_then_env_then_default(monkeypatch):
    geo = tk.matvec_geometry
    default = tk.matvec_default_block_t(2048, torch.float32)
    assert geo(4096, 2048, torch.float32).block_t == default
    monkeypatch.setenv(tk.BLOCKS_ENV, "block_t=100,family_block_t=16")
    assert geo(4096, 2048, torch.float32) == (100, 41)
    assert geo(4096, 2048, torch.float32, 512) == (512, 8)
    # block_t is the matvec's alone: the family kernel reads family_block_t
    assert tk.family_geometry(4096, 2048, False).block_t == 16
    monkeypatch.setenv(tk.BLOCKS_ENV, "family_block_t=16")
    assert geo(4096, 2048, torch.float32).block_t == default
    # the reference's own precedence, for comparison
    monkeypatch.setenv(jk._BLOCKS_ENV, "block_t=64")
    assert jk._block("block_t", None, jk.BLOCK_T) == 64
    assert jk._block("block_t", 32, jk.BLOCK_T) == 32


@pytest.mark.parametrize("T,n,dtype,bt,want", [
    (4096, 2048, torch.float32, None, (16, 256)),
    (4096, 2048, torch.float16, None, (32, 128)),
    (4096, 2048, torch.bfloat16, None, (32, 128)),
    (1024, 512, torch.float16, None, (128, 8)),
    (4097, 1030, torch.float32, None, (24, 171)),
    (128, 256, torch.float32, None, (128, 1)),
    (1000, 6, torch.float32, None, (5456, 1)),
    (8, 10, torch.float32, None, (3272, 1)),
    (0, 10, torch.float32, None, (3272, 1)),
    (4096, 2048, torch.float32, 4096, (4096, 1)),
    (4097, 1030, torch.float32, 200, (200, 21)),
    (37, 23, torch.float32, 5, (5, 8)),
    (37, 23, torch.float64, None, (712, 1)),
])
def test_matvec_geometry(T, n, dtype, bt, want):
    """The tiling is a pure function of (T, n, dtype, block_t): by default
    rows of about MATVEC_TILE_BYTES of phi in whole steps of
    MATVEC_ROW_STEP rows, so a sweep's agents (T <= 128) keep one tile."""
    g = tk.matvec_geometry(T, n, dtype, bt)
    assert tuple(g) == want
    assert g.tiles * g.block_t >= T and (g.tiles - 1) * g.block_t < max(T, 1)
    if bt is None:
        assert g.block_t % tk.MATVEC_ROW_STEP == 0
        assert g.block_t * n * dtype.itemsize <= max(
            tk.MATVEC_TILE_BYTES, tk.MATVEC_ROW_STEP * n * dtype.itemsize)
    assert tk.matvec_geometry(T, n, dtype, bt) == g


@pytest.mark.parametrize("bt", [48, 128])
def test_tiled_matvec_equals_the_interpret_kernel(monkeypatch, rng, bt):
    """gain_matvec and practical_gain on seeded inputs at two block_t
    values, per call and through the env, against the Pallas kernel in
    interpret mode at the same T-tile (the reference's practical_gain at
    its own), within tests/parity.py's WEIGHT_TOL of |want| + 1."""
    T, n = 300, 40
    jphi, tphi = _jt(rng, (T, n))
    jg, tg = _jt(rng, (n,))
    want = jk.gain_matvec(jphi, jg, interpret=True, block_t=bt, block_n=16)
    want_gain = jk.practical_gain(jphi, jg, 0.5, interpret=True)
    _close(tk.gain_matvec(tphi, tg, block_t=bt), want, WEIGHT_TOL)
    _close(tk.practical_gain(tphi, tg, 0.5, block_t=bt), want_gain,
           WEIGHT_TOL)
    monkeypatch.setenv(tk.BLOCKS_ENV, f"block_t={bt}")
    assert tk.matvec_geometry(T, n, tphi.dtype).block_t == bt
    _close(tk.gain_matvec(tphi, tg), want, WEIGHT_TOL)
    _close(tk.practical_gain(tphi, tg, 0.5), want_gain, WEIGHT_TOL)
