"""repro_torch.core against repro.core on shared numpy inputs.

vfa, gain, trigger, server and gain_dispatch (the reference branches) at
the repo's 1e-5 contract (tests/parity.py); transmit decisions exact.  Also
the mode-id pin, the env-var backend defaults, the cuda default device and
the parts this slice refuses.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import gain as jgain  # noqa: E402
from repro.core import gain_dispatch as jgd  # noqa: E402
from repro.core import server as jserver  # noqa: E402
from repro.core import trigger as jtrigger  # noqa: E402
from repro.core import vfa as jvfa  # noqa: E402
from repro.kernels import gain as jkgain  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.core import gain as tgain  # noqa: E402
from repro_torch.core import gain_dispatch as tgd  # noqa: E402
from repro_torch.core import server as tserver  # noqa: E402
from repro_torch.core import trigger as ttrigger  # noqa: E402
from repro_torch.core import vfa as tvfa  # noqa: E402
from repro_torch.kernels import gain as tkgain  # noqa: E402
from repro_torch.kernels import ref as tkref  # noqa: E402

TOL = 1e-5     # tests/parity.py WEIGHT_TOL


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.fixture
def batch(rng):
    R, m, T, n = 2, 3, 8, 5
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(R=R, m=m, T=T, n=n, phi=f(R, m, T, n), tg=f(R, m, T),
                w=f(R, n), g=f(R, m, n), gj=f(R, n), pm=f(n, n),
                pm_r=f(R, n, n), arand=(rng.random((R, m)) < 0.5)
                .astype(np.float32),
                deliver=(rng.random((R, m)) < 0.7).astype(np.float32))


def test_vfa_stochastic_gradient_and_moments(batch):
    b = batch
    want = jax.vmap(jax.vmap(jvfa.stochastic_gradient, (None, 0, 0)))(
        b["w"], b["phi"], b["tg"])
    got = tvfa.stochastic_gradient(_t(b["w"]).unsqueeze(1), _t(b["phi"]),
                                   _t(b["tg"]))
    _close(got, want)
    _close(tvfa.empirical_second_moment(_t(b["phi"][0, 0])),
           jvfa.empirical_second_moment(b["phi"][0, 0]))
    _close(tvfa.bellman_targets(_t(b["tg"][0, 0]), _t(b["tg"][1, 0]), 0.9),
           jvfa.bellman_targets(b["tg"][0, 0], b["tg"][1, 0], 0.9))


def test_vfa_problem(rng):
    S, n = 7, 4
    feats = rng.normal(size=(S, n)).astype(np.float32)
    d = rng.dirichlet(np.ones(S)).astype(np.float32)
    y = rng.normal(size=S).astype(np.float32)
    w = rng.normal(size=n).astype(np.float32)
    jp = jvfa.VFAProblem(jnp.asarray(feats), jnp.asarray(d), jnp.asarray(y), 0.9)
    tp = tvfa.VFAProblem(_t(feats), _t(d), _t(y), 0.9)
    _close(tp.second_moment(), jp.second_moment())
    _close(tp.objective(_t(w)), jp.objective(w))
    _close(tp.grad(_t(w)), jp.grad(w))
    _close(tp.optimum(), jp.optimum(), 1e-4)
    assert tp.n == jp.n and tp.check_assumption_1() == jp.check_assumption_1()
    np.testing.assert_allclose(tp.max_stable_stepsize(),
                               jp.max_stable_stepsize(), rtol=1e-5)
    np.testing.assert_allclose(tp.min_rho(0.3), jp.min_rho(0.3), rtol=1e-5)


def test_gain_formulas(batch):
    b = batch
    g, gj, pm, phi = b["g"][0, 0], b["gj"][0], b["pm"], b["phi"][0, 0]
    phat = jvfa.empirical_second_moment(phi)
    _close(tgain.theoretical_gain(_t(g), _t(gj), _t(pm), 0.3),
           jgain.theoretical_gain(g, gj, pm, 0.3))
    _close(tgain.practical_gain(_t(g), _t(np.asarray(phat)), 0.3),
           jgain.practical_gain(g, phat, 0.3))
    _close(tgain.practical_gain_streaming(_t(g), _t(phi), 0.3),
           jgain.practical_gain_streaming(g, phi, 0.3))
    _close(tgain.gain_norm_only(_t(g), 0.3), jgain.gain_norm_only(g, 0.3))


@pytest.mark.parametrize("lam,rho,N,norm", [
    (1e-4, 0.95, 100, True), (1e-2, 0.999, 14, True), (0.1, 0.9, 20, True),
    (3e-3, 0.5, 25, False), (1.0, 0.97, 80, True)])
def test_trigger_schedule_and_bound(lam, rho, N, norm):
    jc = jtrigger.TriggerConfig(lam, rho, N, include_horizon_norm=norm)
    tc = ttrigger.TriggerConfig(lam, rho, N, include_horizon_norm=norm)
    # float32 pow may round differently in the last ulp
    np.testing.assert_allclose(tc.schedule().numpy(),
                               np.asarray(jc.schedule()), rtol=1e-6)
    assert tc.schedule().dtype == torch.float32
    assert ttrigger.theorem1_bound(lam, rho, 0.2, N, 1.5, 0.1, 0.7) == \
        jtrigger.theorem1_bound(lam, rho, 0.2, N, 1.5, 0.1, 0.7)


def test_trigger_decisions_and_assumptions(rng):
    gains = rng.normal(size=50).astype(np.float32)
    np.testing.assert_array_equal(
        ttrigger.should_transmit(_t(gains), 0.3).numpy(),
        np.asarray(jtrigger.should_transmit(gains, 0.3)))
    eigs = np.asarray([0.1, 0.5, 0.9], np.float32)
    for eps in (0.3, 1.5, 3.0):
        assert ttrigger.check_assumption_2(eps, _t(eigs)) == \
            jtrigger.check_assumption_2(eps, jnp.asarray(eigs))
        assert ttrigger.check_assumption_3(0.9, eps, _t(eigs)) == \
            jtrigger.check_assumption_3(0.9, eps, jnp.asarray(eigs))


def test_server_update(batch):
    b = batch
    alphas = b["arand"]
    want = jax.vmap(jserver.server_update, (0, 0, 0, None))(
        b["w"], b["g"], alphas, 0.4)
    _close(tserver.server_update(_t(b["w"]), _t(b["g"]), _t(alphas), 0.4), want)
    _close(tserver.aggregate(_t(b["g"][0]), _t(np.zeros(b["m"], np.float32))),
           np.zeros(b["n"]))


@pytest.mark.parametrize("per_run_pm", [False, True])
def test_family_stats_and_mode_gains(batch, per_run_pm):
    b = batch
    pm = b["pm_r"] if per_run_pm else b["pm"]
    pm_axis = 0 if per_run_pm else None
    want = jax.vmap(lambda g, p, j, q: jgd.family_stats(
        g, p, j, q, backend="reference"), (0, 0, 0, pm_axis))(
            b["g"], b["phi"], b["gj"], pm)
    got = tgd.family_stats(_t(b["g"]), _t(b["phi"]), _t(b["gj"]), _t(pm),
                           backend="reference")
    for name in want._fields:
        _close(getattr(got, name), getattr(want, name))
    for step in ("reference", "fused", "megastep"):
        for mode in range(6):
            want_g = jax.vmap(lambda g, p, j, q: jgd.mode_gains(
                mode, g, p, 0.3, j, q, backend="reference",
                step_backend=step), (0, 0, 0, pm_axis))(
                    b["g"], b["phi"], b["gj"], pm)
            got_g = tgd.mode_gains(mode, _t(b["g"]), _t(b["phi"]), 0.3,
                                   _t(b["gj"]), _t(pm), backend="reference",
                                   step_backend=step)
            _close(got_g, want_g)
    # per-run mode ids select per run
    modes = torch.tensor([0, 2])
    mixed = tgd.mode_gains(modes, _t(b["g"]), _t(b["phi"]), 0.3, _t(b["gj"]),
                           _t(pm), backend="reference", step_backend="fused")
    for r in range(b["R"]):
        solo = tgd.mode_gains(int(modes[r]), _t(b["g"]), _t(b["phi"]), 0.3,
                              _t(b["gj"]), _t(pm), backend="reference",
                              step_backend="fused")[r]
        torch.testing.assert_close(mixed[r], solo, rtol=0, atol=0)


@pytest.mark.parametrize("with_deliver", [False, True])
@pytest.mark.parametrize("per_run_pm", [False, True])
def test_megastep_reference_branch(batch, with_deliver, per_run_pm):
    b = batch
    pm = b["pm_r"] if per_run_pm else b["pm"]
    thresh = np.float32(0.8 * np.median(np.abs(b["g"])))
    for mode in range(6):
        want = jax.vmap(lambda w, g, p, a, j, q, dl: jgd.megastep(
            mode, w, g, p, 0.5, thresh, a, j, q, backend="reference",
            deliver=dl if with_deliver else None),
            (0, 0, 0, 0, 0, 0 if per_run_pm else None, 0))(
                b["w"], b["g"], b["phi"], b["arand"], b["gj"], pm,
                b["deliver"])
        got = tgd.megastep(mode, _t(b["w"]), _t(b["g"]), _t(b["phi"]), 0.5,
                           float(thresh), _t(b["arand"]), _t(b["gj"]), _t(pm),
                           backend="reference",
                           deliver=_t(b["deliver"]) if with_deliver else None)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        _close(got[0], want[0])
        _close(got[2], want[2])


def test_mode_ids_are_pinned():
    """One enum across the port, its kernels and the reference."""
    assert tgd.MODES == tkref.MODES == jgd.MODES
    for i, name in enumerate(tgd.MODES):
        key = f"MODE_{name.upper()}"
        assert getattr(tgd, key) == getattr(jgd, key) == i
        assert getattr(tkref, key) == i
        assert getattr(jkgain, f"_MODE_{name.upper()}") == i
    cu = (Path(tkgain.__file__).parent / "csrc" / "gain.cu").read_text()
    cu_modes = re.findall(r"constexpr float kMode(\w+) = (\d)\.f;", cu)
    assert len(cu_modes) == 5
    for name, val in cu_modes:
        assert getattr(tkref, f"MODE_{name.upper()}") == int(val)
    assert tkgain.STAT_QUAD == jkgain.STAT_QUAD == 3


def test_backend_defaults_from_env(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_GAIN_BACKEND", raising=False)
    monkeypatch.delenv("REPRO_TORCH_STEP_BACKEND", raising=False)
    assert tgd.default_backend() == "kernel"
    assert tgd.default_step_backend() == "megastep"
    monkeypatch.setenv("REPRO_TORCH_GAIN_BACKEND", "reference")
    monkeypatch.setenv("REPRO_TORCH_STEP_BACKEND", "fused")
    assert tgd._resolve(None) == "reference"
    assert tgd._resolve_step(None) == "fused"
    monkeypatch.setenv("REPRO_TORCH_GAIN_BACKEND", "pallas")
    with pytest.raises(ValueError):
        tgd._resolve(None)


def test_default_device_is_cuda_and_never_falls_back():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert repro_torch.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.resolve_device(None)
