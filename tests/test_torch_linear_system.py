"""repro_torch.envs.linear_system (paper §V, Fig. 3) against
repro.envs.linear_system.

The exact quantities (closed-form Phi, Bellman target weights, the
quadrature problem) equal the reference's; the samplers draw the
reference's streams (phi exactly, targets at 1e-6 relative); one inner run
(tests/test_algorithm1.py:168) and Fig. 3's sweep at its smoke size
(benchmarks/fig3_continuous.py, N = 100, T = 64) match the reference at
the parity tolerances (weights 1e-5, decisions exact with ties reported).
The checks of tests/test_envs.py:57-83 and tests/test_sweep.py:366 run on
the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import algorithm1 as ja1  # noqa: E402
from repro.core.trigger import TriggerConfig as JTrig  # noqa: E402
from repro.envs import LinearSystem as JLS  # noqa: E402
from repro.envs.linear_system import poly_features as jpoly  # noqa: E402
from repro.experiments import SweepSpec as JSpec  # noqa: E402
from repro.experiments import run_sweep as jrun_sweep  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import algorithm1 as ta1  # noqa: E402
from repro_torch.core.trigger import TriggerConfig as TTrig  # noqa: E402
from repro_torch.envs import LinearSystem as TLS  # noqa: E402
from repro_torch.envs.linear_system import poly_features  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402

from test_torch_algorithm1 import (PAIRS, decision_ties,  # noqa: E402
                                   one_thread)  # noqa: F401  (fixture)

TOL, RATE_TOL, TARGET_RTOL = 1e-5, 1e-6, 1e-6
# long loops of tiny ops run on one intra-op thread (one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")
JSYS, TSYS = JLS(), TLS()
V = np.random.default_rng(4).normal(size=6).astype(np.float32)


def _tkeys(jkeys):
    return convert.key_to_torch(jax.random.key_data(jkeys), device="cpu")


def test_closed_forms_equal_reference():
    np.testing.assert_array_equal(TSYS.second_moment(), JSYS.second_moment())
    vw = np.array([0.5, -0.2, 0.3, 0.1, -0.4, 0.7])
    np.testing.assert_array_equal(TSYS.bellman_target_weights(vw),
                                  JSYS.bellman_target_weights(vw))
    tp, jp = TSYS.vfa_problem(vw, grid=16), JSYS.vfa_problem(vw, grid=16)
    for name in ("phi_matrix", "d_weights", "targets"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    x = np.random.default_rng(1).uniform(size=(5, 2)).astype(np.float32)
    np.testing.assert_array_equal(poly_features(torch.from_numpy(x)).numpy(),
                                  np.asarray(jpoly(jnp.asarray(x))))


def test_linear_system_phi_closed_form_matches_quadrature():
    phi_exact = TSYS.second_moment()
    prob = TSYS.vfa_problem(np.zeros(6), grid=128)
    np.testing.assert_allclose(prob.second_moment().numpy(), phi_exact,
                               atol=2e-5)
    assert np.linalg.eigvalsh(phi_exact).min() > 0   # Assumption 1


def test_linear_system_bellman_weights_match_monte_carlo():
    """Closed-form target polynomial == MC estimate of c(x) + g E V(Ax+w),
    with the port's normal draws."""
    vw = np.array([0.5, -0.2, 0.3, 0.1, -0.4, 0.7])
    tw = TSYS.bellman_target_weights(vw)
    noise = (trandom.normal(trandom.key(0), (200_000, 2)).double().numpy()
             * np.sqrt(TSYS.noise_var))
    for xi in np.array([[0.3, 0.8], [0.1, 0.2], [0.9, 0.5]]):
        xn = torch.from_numpy(xi @ TSYS.A.T + noise)
        mc = xi @ xi + TSYS.gamma * (poly_features(xn).numpy() @ vw).mean()
        exact = poly_features(torch.from_numpy(xi)).numpy() @ tw
        np.testing.assert_allclose(exact, mc, rtol=2e-2)


@pytest.mark.parametrize("noise_scale", [1.0, 2.5])
def test_samplers_draw_the_reference_streams(noise_scale):
    """sampler_fn (batched over runs and agents) and make_sampler against
    the reference's per-key draws: phi exactly, targets at 1e-6."""
    jkeys = jax.random.split(jax.random.key(9), 6).reshape(2, 3)
    jrow = JSYS.agent_param_row(jnp.asarray(V), noise_scale)
    jphi, jy = jax.vmap(jax.vmap(JSYS.sampler_fn(64), (None, 0)),
                        (None, 0))(jrow, jkeys)
    params = TSYS.agent_params(V, 3, noise_scale)
    params = {k: v.expand((2,) + v.shape) for k, v in params.items()}
    tphi, ty = TSYS.sampler_fn(64)(params, _tkeys(jkeys))
    np.testing.assert_array_equal(tphi.numpy(), np.asarray(jphi))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TARGET_RTOL,
                               atol=TARGET_RTOL)
    if noise_scale == 1.0:
        lphi, ly = TSYS.make_sampler(V, 64)(_tkeys(jkeys))
        np.testing.assert_array_equal(lphi.numpy(), tphi.numpy())
        np.testing.assert_allclose(ly.numpy(), ty.numpy(), rtol=1e-6)


def test_linear_system_param_sampler_matches_closure():
    key = trandom.key(9)
    phi_a, t_a = TSYS.sampler_fn(64)(
        {k: v[None] for k, v in TSYS.agent_param_row(V).items()}, key[None])
    phi_b, t_b = TSYS.make_sampler(V, 64)(key)
    np.testing.assert_array_equal(phi_a[0].numpy(), phi_b.numpy())
    np.testing.assert_allclose(t_a[0].numpy(), t_b.numpy(), rtol=1e-6)


def test_linear_system_sampler_features():
    phi_t, targets = TSYS.make_sampler(torch.zeros(6), 1000)(trandom.key(0))
    assert phi_t.shape == (1000, 6)
    np.testing.assert_allclose(phi_t[:, 5].numpy(), 1.0)      # bias feature
    assert bool((targets >= 0).all())       # c(x) >= 0 and V_cur = 0


def test_continuous_state_practical_runs():
    """Fig. 3's setup, one inner run (tests/test_algorithm1.py:168), on the
    port against the reference's run with the same eps and rho."""
    jprob = JSYS.vfa_problem(np.zeros(6))
    eps = 0.9 * jprob.max_stable_stepsize()
    rho = min(jprob.min_rho(eps) * 1.001, 0.9999)
    kw = dict(eps=eps, num_agents=2, mode="practical")
    ref = ja1.run_gated_sgd(
        jax.random.key(0), jnp.zeros(6), JSYS.make_sampler(jnp.zeros(6), 1000),
        ja1.GatedSGDConfig(trigger=JTrig(1e-5, rho, 300), **kw,
                           gain_backend="reference", step_backend="reference"),
        problem=jprob)
    tprob = TSYS.vfa_problem(np.zeros(6))
    tr = ta1.run_gated_sgd(
        trandom.key(0), torch.zeros(6), TSYS.make_sampler(torch.zeros(6), 1000),
        ta1.GatedSGDConfig(trigger=TTrig(1e-5, rho, 300), **kw,
                           gain_backend="kernel", step_backend="megastep"),
        problem=tprob, device="cpu")
    j0 = float(tprob.objective(torch.zeros(6)))
    jn = float(tprob.objective(tr.weights[-1]))
    assert jn < 0.1 * j0, (jn, j0)
    assert 0.0 < float(tr.comm_rate) <= 1.0
    thr = np.asarray(JTrig(1e-5, rho, 300).schedule())[None]
    assert not decision_ties(tr.alphas[None].numpy(),
                             np.asarray(ref.alphas)[None],
                             np.asarray(ref.gains)[None], thr)
    np.testing.assert_allclose(tr.weights.numpy(), np.asarray(ref.weights),
                               rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def fig3_smoke():
    """Fig. 3's two sweeps at the study's smoke size through the reference."""
    jprob = JSYS.vfa_problem(np.zeros(6))
    eps = 0.9 * jprob.max_stable_stepsize()
    rho = min(jprob.min_rho(eps) * 1.0001, 0.9995)
    out = {}
    for agents, lambdas in ((2, (1e-1, 1e-4, 1e-2)), (10, (1e-2,))):
        spec = dict(modes=("practical",), lambdas=lambdas, seeds=(0,),
                    rhos=(rho,), eps=eps, num_iterations=100,
                    num_agents=agents)
        res = jrun_sweep(JSpec(**spec), ja1.ParamSampler(
            JSYS.sampler_fn(64), JSYS.agent_params(jnp.zeros(6), agents)),
            jnp.zeros(6), problem=jprob)
        out[agents] = (spec, res)
    return out


@pytest.mark.parametrize("step,gain", PAIRS)
def test_fig3_sweep_matches_reference(fig3_smoke, step, gain):
    """Both sweeps of the study (2 agents at three lambdas, 10 at one) on
    every backend pair: weights 1e-5, decisions exact, comm rate 1e-6,
    J_final at 1e-5."""
    tprob = TSYS.vfa_problem(np.zeros(6))
    for agents, (spec, ref) in fig3_smoke.items():
        res = tsweep.run_sweep(
            tsweep.SweepSpec(**spec, step_backend=step, gain_backend=gain),
            ta1.ParamSampler(TSYS.sampler_fn(64),
                             TSYS.agent_params(torch.zeros(6), agents)),
            np.zeros(6, np.float32), problem=tprob, device="cpu")
        L = len(spec["lambdas"])
        thr = np.stack([np.asarray(JTrig(lam, spec["rhos"][0], 100).schedule())
                        for lam in spec["lambdas"]])
        flat = lambda x: np.asarray(x).reshape(L, 100, agents)  # noqa: E731
        assert not decision_ties(flat(res.trace.alphas),
                                 flat(ref.trace.alphas),
                                 flat(ref.trace.gains), thr)
        assert 0 < float(res.comm_rate.mean()) < 1
        np.testing.assert_allclose(res.trace.weights.numpy(),
                                   np.asarray(ref.trace.weights),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(res.comm_rate.numpy(),
                                   np.asarray(ref.comm_rate), rtol=RATE_TOL)
        np.testing.assert_allclose(res.j_final.numpy(),
                                   np.asarray(ref.j_final), rtol=TOL,
                                   atol=TOL)
