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
    assert tss.LAUNCHES == {"ssd_chunk_tiles": 0}


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
