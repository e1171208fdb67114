"""The port's kernel modules, plain path, against repro.kernels.

Each wrapper's CPU path (its plain version) is held against
``repro.kernels.ref`` and against the Pallas kernels of
``repro.kernels.gain`` run as tests/test_kernels.py runs them (interpret
mode), at small ragged shapes in float32 and bf16.  Both sides widen bf16
to float32 the same way, so one tolerance serves both dtypes: 2e-4 on the
scale-normalized error, as tests/test_kernels.py; transmit decisions are
exact.  The CUDA kernels themselves run only on the card (chip_smoke.py);
here a wrapper must refuse, not fall back, on any non-CPU tensor.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import gain as jk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import gain as tk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

TOL = 2e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dt):
    """One random array as (jax, torch) with identical values in ``dt``."""
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(DTYPES[dt][0])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(DTYPES[dt][1])
    return j, t


@pytest.fixture
def rng(request):
    """A generator per test, so inputs do not depend on test order."""
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _close(got, want, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want) + 1.0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


# (T, n) -> whether matvec_gain_kernel takes its vector pass (else the
# generic scalar pass) for 16-byte-aligned float32 / bf16 rows
MATVEC_PASSES = {(10, 6): (False, False), (257, 130): (False, False),
                 (128, 256): (True, True), (64, 512): (True, True)}


@pytest.mark.parametrize("T,n", list(MATVEC_PASSES))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gain_matvec_and_practical_gain(rng, T, n, dt):
    """Ragged widths (the kernel's scalar pass) and n = 256, 512 (its vector
    pass), with the pass the wrapper would launch pinned."""
    phi_j, phi_t = _pair(rng, (T, n), dt)
    g_j, g_t = _pair(rng, (n,), dt)
    assert tk.matvec_vector_pass(n, DTYPES[dt][1], phi_t.data_ptr(),
                                 g_t.data_ptr()) == MATVEC_PASSES[(T, n)][dt == "bf16"]
    got = tk.gain_matvec(phi_t, g_t)
    assert got.dtype == torch.float32 and got.shape == (T,)
    _close(got, jref.gain_matvec_ref(phi_j, g_j))
    _close(got, jk.gain_matvec(phi_j, g_j))
    gp = tk.practical_gain(phi_t, g_t, 0.5)
    _close(gp, jref.practical_gain_ref(phi_j, g_j, 0.5))
    _close(gp, jk.practical_gain(phi_j, g_j, eps=0.5))


@pytest.mark.parametrize("n,dtype,addresses,vector", [
    (256, torch.float32, (0, 0), True), (512, torch.float32, (0, 0), True),
    (128, torch.float32, (0, 0), True), (4, torch.float32, (0, 0), True),
    (260, torch.float32, (0, 0), True), (1024, torch.float32, (0, 0), True),
    (1028, torch.float32, (0, 0), True), (130, torch.float32, (0, 0), False),
    (25, torch.float32, (0, 0), False), (6, torch.float32, (0, 0), False),
    (256, torch.bfloat16, (0, 0), True), (512, torch.bfloat16, (0, 0), True),
    (2048, torch.bfloat16, (0, 0), True), (2056, torch.bfloat16, (0, 0), True),
    (252, torch.bfloat16, (0, 0), False), (130, torch.bfloat16, (0, 0), False),
    (256, torch.float32, (4, 0), False), (256, torch.float32, (0, 8), False),
    (256, torch.bfloat16, (16, 32), True), (0, torch.float32, (0, 0), False),
    (4096, torch.float32, (0, 0), True), (8, torch.bfloat16, (0, 48), True)])
def test_matvec_vector_loads_predicate(n, dtype, addresses, vector):
    """The wrapper's choice of pass: the vector pass wherever every row is
    whole 16-byte vectors and phi and g are 16-byte aligned, at any n (past
    the columns whose g a lane holds in registers it loops over chunks)."""
    assert tk.matvec_vector_pass(n, dtype, *addresses) is vector


def test_gain_matvec_takes_the_run_and_agent_axes(rng):
    """One call over (R, m) agents = the reference vmapped per agent."""
    phi_j, phi_t = _pair(rng, (2, 3, 12, 7), "f32")
    g_j, g_t = _pair(rng, (2, 3, 7), "f32")
    want = jax.vmap(jax.vmap(lambda p, g: jk.practical_gain(p, g, eps=0.3)))(
        phi_j, g_j)
    _close(tk.practical_gain(phi_t, g_t, 0.3), want)


@pytest.mark.parametrize("m,T,n", [(1, 10, 6), (13, 100, 30)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gain_family_stats(rng, m, T, n, dt):
    phi_j, phi_t = _pair(rng, (m, T, n), dt)
    g_j, g_t = _pair(rng, (m, n), dt)
    gj_j, gj_t = _pair(rng, (n,), "f32")
    pm_j, pm_t = _pair(rng, (n, n), "f32")
    got = tk.gain_family_stats(phi_t, g_t, gj_t, pm_t)
    assert got.shape == (m, 4) and got.dtype == torch.float32
    _close(got, jref.gain_family_stats_ref(phi_j, g_j, gj_j, pm_j))
    _close(got, jk.gain_family_stats(phi_j, g_j, gj_j, pm_j))
    two = tk.gain_family_stats(phi_t, g_t)
    assert two.shape == (m, 2)
    _close(two, jk.gain_family_stats(phi_j, g_j))


def test_gain_family_stats_per_run_terms(rng):
    """Per-run grad_j and Phi (an env-family sweep) = the reference vmapped."""
    G, m, T, n = 3, 5, 12, 9
    phi_j, phi_t = _pair(rng, (G, m, T, n), "f32")
    g_j, g_t = _pair(rng, (G, m, n), "f32")
    gj_j, gj_t = _pair(rng, (G, n), "f32")
    pm_j, pm_t = _pair(rng, (G, n, n), "f32")
    want = jax.vmap(jk.gain_family_stats)(phi_j, g_j, gj_j, pm_j)
    _close(tk.gain_family_stats(phi_t, g_t, gj_t, pm_t), want)
    shared = tk.gain_family_stats(phi_t, g_t, gj_t, pm_t[0])
    want = jax.vmap(lambda p, g, j: jk.gain_family_stats(p, g, j, pm_j[0]))(
        phi_j, g_j, gj_j)
    _close(shared, want)


def _mega_inputs(rng, R, m, T, n, dt="f32", per_run_pm=False):
    phi = _pair(rng, (R, m, T, n), dt)
    g = _pair(rng, (R, m, n), dt)
    w = _pair(rng, (R, n), "f32")
    gj = _pair(rng, (R, n), "f32")
    pm = _pair(rng, (R, n, n) if per_run_pm else (n, n), "f32")
    a = rng.integers(0, 2, size=(R, m)).astype(np.float32)
    dl = rng.integers(0, 2, size=(R, m)).astype(np.float32)
    return phi, g, w, gj, pm, (jnp.asarray(a), torch.from_numpy(a)), \
        (jnp.asarray(dl), torch.from_numpy(dl))


@pytest.mark.parametrize("m,T,n", [(2, 8, 25), (5, 37, 23)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_megastep_all_modes(rng, m, T, n, dt):
    """Six runs, one per trigger mode, in one call of each side."""
    R = 6
    phi, g, w, gj, pm, a, _ = _mega_inputs(rng, R, m, T, n, dt)
    thresh = 0.8 * float(np.median(np.abs(np.asarray(g[1].float()))))
    ctl = np.stack([np.full(R, thresh, np.float32),
                    np.arange(R, dtype=np.float32)], -1)
    got = tk.megastep_call(phi[1], g[1], w[1], torch.from_numpy(ctl), a[1],
                           gj[1], pm[1], eps=0.5)
    want = jk.megastep_call(phi[0], g[0], w[0], jnp.asarray(ctl), a[0],
                            gj[0], pm[0], eps=0.5)
    oracle = jax.vmap(lambda p, gg, ww, c, ar, j: jref.megastep_ref(
        p, gg, ww, c, ar, j, pm[0], eps=0.5))(
            phi[0], g[0], w[0], jnp.asarray(ctl), a[0], gj[0])
    for ref_out in (want, oracle):
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref_out[1]))
        _close(got[0], ref_out[0])
        _close(got[2], ref_out[2])


def test_megastep_deliver_per_run_phi_and_model_free(rng):
    R, m, T, n = 3, 5, 12, 9
    phi, g, w, gj, pm, a, dl = _mega_inputs(rng, R, m, T, n, per_run_pm=True)
    ctl = np.stack([np.full(R, 0.05, np.float32),
                    np.asarray([0, 1, 3], np.float32)], -1)
    got = tk.megastep_call(phi[1], g[1], w[1], torch.from_numpy(ctl), a[1],
                           gj[1], pm[1], dl[1], eps=0.5)
    want = jk.megastep_call(phi[0], g[0], w[0], jnp.asarray(ctl), a[0],
                            gj[0], pm[0], dl[0], eps=0.5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0])
    _close(got[2], want[2])
    ctl[:, 1] = 1.0
    got = tk.megastep_call(phi[1], g[1], w[1], torch.from_numpy(ctl), a[1],
                           eps=0.5)
    want = jk.megastep_call(phi[0], g[0], w[0], jnp.asarray(ctl), a[0],
                            eps=0.5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0], want[0])
    # the per-run entry is megastep_call at R = 1
    one = tk.megastep(phi[1][0], g[1][0], w[1][0], torch.from_numpy(ctl[0]),
                      a[1][0], eps=0.5)
    for x, y in zip(one, got):
        torch.testing.assert_close(x, y[0], rtol=0, atol=0)


def test_cpu_tensors_never_count_launches(rng):
    tk.reset_launches()
    _, phi = _pair(rng, (2, 4, 8, 5), "f32")
    _, g = _pair(rng, (2, 4, 5), "f32")
    tk.practical_gain(phi, g, 0.1)
    tk.gain_family_stats(phi, g)
    assert tk.LAUNCHES == {"gain_matvec": 0, "gain_family_stats": 0,
                           "megastep": 0, "gain_matvec_f16": 0,
                           "gain_family_stats_f16": 0, "megastep_f16": 0}


def test_non_cpu_tensors_raise_instead_of_falling_back():
    """A wrapper runs its plain version only for CPU tensors."""
    phi = torch.empty((4, 8, 5), device="meta")
    g = torch.empty((4, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.gain_family_stats(phi, g)
    with pytest.raises(ValueError, match="span devices"):
        tk.gain_matvec(phi, torch.zeros((4, 5)))


@pytest.mark.cuda
def test_cuda_wrapper_raises_when_the_build_is_missing(monkeypatch, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run in chip_smoke.py")
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    phi = torch.zeros((2, 3, 4), device="cuda")
    with pytest.raises((RuntimeError, OSError)):
        tk.gain_family_stats(phi, torch.zeros((2, 4), device="cuda"))


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """The build names its source by content and never returns a stale or
    missing library: without a CUDA compiler it raises."""
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert build.library_path().parent == tmp_path
    assert build.library_path().name.startswith("librepro_torch_kernels_")
    monkeypatch.setattr(build, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(force=True)
    assert not list(tmp_path.glob("*.so"))
