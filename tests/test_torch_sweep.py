"""The slice as a whole: repro_torch's run_sweep against repro's.

A small garnet family (E=2, S=12, m=3 with 1 junk agent, T=8, N=20, six
modes x 2 lambdas x 2 seeds) through ``repro.experiments.run_sweep`` (the
reference step and gain backends, the oracle) and through the port on
every (step, gain) backend pair: comm_rate at 1e-6, tx_counts and
decisions exact (tie-aware), final weights and gains at 1e-5, trade-off
rows at the same tolerances.  ``j_final`` is held at tolerance, never
bitwise (ROADMAP queue 3 item 1), and the heterogeneous scenario is not a
learning check (item 2).  Inside the port: per-run <-> sweep, chunked and
one-run-at-a-time execution, and the JAX -> port state round trip.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.algorithm1 import ParamSampler as JPS  # noqa: E402
from repro.envs import family_sampler_fn as jfamily_fn  # noqa: E402
from repro.envs import garnet as jgarnet  # noqa: E402
from repro.experiments import sweep as jsweep  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import algorithm1 as ta1  # noqa: E402
from repro_torch.core.trigger import TriggerConfig as TTrig  # noqa: E402
from repro_torch.envs import family_sampler_fn as tfamily_fn  # noqa: E402
from repro_torch.envs import garnet as tgarnet  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402

from test_torch_algorithm1 import PAIRS, decision_ties  # noqa: E402

TOL, RATE_TOL = 1e-5, 1e-6
E, S, M, JUNK, T, N = 2, 12, 3, 1, 8, 20
MODES = ("theoretical", "practical", "norm", "random", "always", "never")
GRID = dict(modes=MODES, lambdas=(1e-3, 1e-2), seeds=(0, 1), rhos=(0.95,),
            eps=1.0, num_iterations=N, num_agents=M, random_tx_prob=0.4)


@pytest.fixture(scope="module")
def inputs():
    w0 = np.zeros(S, np.float32)
    jenvs, jfam = jgarnet.garnet_env_family(E, num_states=S)
    jfleet = jgarnet.garnet_fleet_sets(jenvs, w0, M, num_junk=JUNK)
    return dict(w0=w0, jfam=jfam, jfleet=jfleet,
                tfam=convert.to_torch(jfam, device="cpu"),
                tfleet=convert.to_torch(jfleet, device="cpu"))


def _jax(inputs, **kw):
    spec = jsweep.SweepSpec(**GRID, step_backend="reference",
                            gain_backend="reference", **kw)
    return spec, jsweep.run_sweep(spec, JPS(jfamily_fn(T), None),
                                  jnp.asarray(inputs["w0"]),
                                  env_sets=inputs["jfam"],
                                  fleet_sets=inputs["jfleet"])


def _port(inputs, step="megastep", gain="kernel", **kw):
    spec = tsweep.SweepSpec(**GRID, step_backend=step, gain_backend=gain,
                            **kw)
    return spec, tsweep.run_sweep(spec, ta1.ParamSampler(tfamily_fn(T), None),
                                  inputs["w0"], env_sets=inputs["tfam"],
                                  fleet_sets=inputs["tfleet"], device="cpu")


@pytest.fixture(scope="module")
def oracle(inputs):
    return _jax(inputs)


def _close_gains(got, want, scale_from=None):
    """Gains at 1e-5 of their run's scale.  A gain is the difference of two
    terms of size eps ||g||^2 (eq. 13/15), and the junk agent's noisy
    gradients make those terms ~100x the difference; the stochastic
    gradients' summation order (torch vs XLA) moves each term by ~1e-7 of
    its size, so the error is relative to the run's largest gain, not to
    each (possibly near-zero) gain."""
    got, want = np.asarray(got), np.asarray(want)
    src = np.abs(np.asarray(want if scale_from is None else scale_from))
    scale = src.reshape(src.shape[:5] + (-1,)).max(-1)
    scale = scale.reshape(scale.shape + (1,) * (want.ndim - 5))
    assert np.all(np.abs(got - want) <= TOL * (scale + 1.0))


def _thresholds(spec, shape):
    """(runs, N) lambda_k per flattened run of an (E, M, L, R, S) grid."""
    thr = spec.thresholds()                       # (L, R, N)
    return np.broadcast_to(thr[None, None, :, :, None, :],
                           shape + (N,)).reshape(-1, N)


@pytest.mark.parametrize("step,gain", PAIRS)
def test_sweep_matches_reference(inputs, oracle, step, gain):
    jspec, ref = oracle
    tspec, got = _port(inputs, step, gain)
    assert got.axes == ref.axes
    ga = got.trace.alphas.numpy().reshape(-1, N, M)
    ra = np.asarray(ref.trace.alphas).reshape(-1, N, M)
    tied = decision_ties(ga, ra, np.asarray(ref.trace.gains).reshape(-1, N, M),
                         _thresholds(tspec, got.comm_rate.shape))
    assert not tied
    np.testing.assert_array_equal(ga, ra)
    np.testing.assert_allclose(got.comm_rate.numpy(), np.asarray(ref.comm_rate),
                               rtol=RATE_TOL, atol=RATE_TOL)
    np.testing.assert_allclose(got.final_weights.numpy(),
                               np.asarray(ref.final_weights), rtol=TOL, atol=TOL)
    _close_gains(got.trace.gains.numpy(), ref.trace.gains)
    np.testing.assert_allclose(got.j_final.numpy(), np.asarray(ref.j_final),
                               rtol=1e-4, atol=TOL)
    for a, b in zip(tsweep.tradeoff_rows(got, tspec, tag="x"),
                    jsweep.tradeoff_rows(ref, jspec, tag="x")):
        assert {k: a[k] for k in ("mode", "lam", "rho", "env_set", "tag")} == \
            {k: b[k] for k in ("mode", "lam", "rho", "env_set", "tag")}
        assert a["comm_rate"] == pytest.approx(b["comm_rate"], abs=RATE_TOL)
        assert a["J_final"] == pytest.approx(b["J_final"], rel=1e-4, abs=TOL)
        assert a["metric8"] == pytest.approx(b["metric8"], rel=1e-4, abs=TOL)
    np.testing.assert_allclose(
        tsweep.matched_random_probs(got, tspec),
        jsweep.matched_random_probs(ref, jspec), atol=RATE_TOL)


def test_summary_sweep_matches_reference(inputs, oracle):
    """The summary trace against the same oracle's full trace, reduced."""
    _, ref = oracle
    _, got = _port(inputs, trace="summary")
    alphas, gains = np.asarray(ref.trace.alphas), np.asarray(ref.trace.gains)
    np.testing.assert_array_equal(got.trace.tx_counts.numpy(),
                                  alphas.sum(axis=-2))
    np.testing.assert_allclose(got.trace.final_weights.numpy(),
                               np.asarray(ref.final_weights),
                               rtol=TOL, atol=TOL)
    extremes = np.abs(gains).max(axis=-2)
    for name, want in (("gain_mean", gains.mean(axis=-2)),
                       ("gain_min", gains.min(axis=-2)),
                       ("gain_max", gains.max(axis=-2))):
        _close_gains(getattr(got.trace, name).numpy(), want, extremes)
    np.testing.assert_allclose(got.comm_rate.numpy(), np.asarray(ref.comm_rate),
                               rtol=RATE_TOL, atol=RATE_TOL)
    np.testing.assert_allclose(got.j_final.numpy(), np.asarray(ref.j_final),
                               rtol=1e-4, atol=TOL)


def test_chunked_and_per_run_execution_agree(inputs):
    """One batch, chunks of 7 (padded), and one run at a time."""
    _, whole = _port(inputs, trace="summary")
    for kw in (dict(chunk_size=7), dict(batching="map")):
        _, other = _port(inputs, trace="summary", **kw)
        for name in ("final_weights", "tx_counts", "gain_mean"):
            torch.testing.assert_close(getattr(other.trace, name),
                                       getattr(whole.trace, name),
                                       rtol=1e-6, atol=1e-6)


def test_one_run_per_stream_keeps_each_runs_fleet(inputs):
    """A grid where every run has its own (seed, env) stream draws per run
    in grid order: the cell equals the same cell of the shared-draw grid."""
    _, whole = _port(inputs, trace="summary")
    spec = tsweep.SweepSpec(**{**GRID, "modes": ("practical",),
                               "lambdas": (1e-2,)}, trace="summary")
    one = tsweep.run_sweep(spec, ta1.ParamSampler(tfamily_fn(T), None),
                           inputs["w0"], env_sets=inputs["tfam"],
                           fleet_sets=inputs["tfleet"], device="cpu")
    torch.testing.assert_close(one.trace.final_weights[:, 0, 0],
                               whole.trace.final_weights[:, 1, 1],
                               rtol=1e-6, atol=1e-6)


def test_per_run_api_equals_the_sweep_cell():
    """run_gated_sgd on one cell = that cell of a shared-fleet sweep."""
    env = tgarnet.GarnetMDP(num_states=S)
    w0 = np.zeros(S, np.float32)
    sampler = ta1.ParamSampler(env.sampler_fn(T), env.agent_params(w0, M))
    prob = env.vfa_problem(w0)
    spec = tsweep.SweepSpec(**GRID, trace="full")
    res = tsweep.run_sweep(spec, sampler, w0, prob, device="cpu")
    for mi, li, si in ((0, 0, 1), (3, 1, 0), (1, 1, 1)):
        cfg = ta1.GatedSGDConfig(
            trigger=TTrig(spec.lambdas[li], spec.rhos[0], N), eps=spec.eps,
            num_agents=M, mode=MODES[mi], random_tx_prob=0.4)
        one = ta1.run_gated_sgd(trandom.key(spec.seeds[si]), w0, sampler, cfg,
                                problem=prob, device="cpu")
        cell = (mi, li, 0, si)
        torch.testing.assert_close(one.weights, res.trace.weights[cell],
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(one.alphas, res.trace.alphas[cell],
                                   rtol=0, atol=0)


def test_param_set_axis_matches_reference():
    """Fig 2's regimes as a param-set grid axis on one gridworld."""
    from repro.envs.gridworld import GridWorld as JGrid
    from repro_torch.envs.gridworld import GridWorld as TGrid
    jenv, tenv = JGrid(), TGrid()
    v = np.asarray(jenv.exact_value(), np.float32) * 0.5
    skew = np.zeros(jenv.num_states, np.float32)
    skew[3] = 30.0

    def sets(env, stack):
        clean = env.agent_param_row(v)
        junk = env.agent_param_row(v, visit_logits=skew, noise_scale=2.0)
        return stack(stack(clean, clean), stack(clean, junk))

    jsets = sets(jenv, lambda *r: jax.tree.map(lambda *x: jnp.stack(x), *r))
    tsets = sets(tenv, lambda *r: {k: torch.stack([x[k] for x in r])
                                   for k in r[0]})
    grid = dict(GRID, modes=("practical", "norm", "random"), num_agents=2,
                eps=0.5, trace="summary")
    jprob, tprob = jenv.vfa_problem(v), tenv.vfa_problem(v)
    ref = jsweep.run_sweep(
        jsweep.SweepSpec(**grid, step_backend="reference",
                         gain_backend="reference"),
        JPS(jenv.sampler_fn(T), None), jnp.zeros(jenv.num_states), jprob,
        param_sets=jsets)
    got = tsweep.run_sweep(tsweep.SweepSpec(**grid),
                           ta1.ParamSampler(tenv.sampler_fn(T), None),
                           np.zeros(tenv.num_states, np.float32), tprob,
                           param_sets=tsets, device="cpu")
    assert got.axes == ref.axes == ("param_set",) + tsweep.BASE_AXES
    np.testing.assert_array_equal(got.trace.tx_counts.numpy(),
                                  np.asarray(ref.trace.tx_counts))
    np.testing.assert_allclose(got.final_weights.numpy(),
                               np.asarray(ref.final_weights),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.j_final.numpy(), np.asarray(ref.j_final),
                               rtol=1e-4, atol=TOL)


def test_convert_round_trip(inputs):
    back = convert.to_numpy(inputs["tfam"])
    assert type(back).__name__ == "EnvFamily"
    for k, v in inputs["jfam"].params.items():
        np.testing.assert_array_equal(back.params[k], np.asarray(v))
    for a, b in zip(back.terms, inputs["jfam"].terms):
        np.testing.assert_array_equal(a, np.asarray(b))
    for k, v in inputs["jfleet"].items():
        np.testing.assert_array_equal(convert.to_numpy(inputs["tfleet"])[k],
                                      np.asarray(v))
    key = jax.random.split(jax.random.key(9), 3)
    np.testing.assert_array_equal(
        convert.key_to_torch(jax.random.key_data(key), device="cpu").numpy(),
        np.asarray(jax.random.key_data(key)).astype(np.int64))
    with pytest.raises(TypeError):
        convert.to_torch(_Unknown(1), device="cpu")


class _Unknown(tuple):
    _fields = ("x",)

    def __new__(cls, x):
        return super().__new__(cls, (x,))


def test_sweep_refusals(inputs):
    with pytest.raises(ValueError, match="megastep.*delay"):
        tsweep.SweepSpec(**GRID, step_backend="megastep",
                         channel_sets=((0.0, 1, 0),))
    # the reference's own checks of the sampling axis
    markov = tsweep.SweepSpec(**GRID, sampling="markov")
    with pytest.raises(ValueError, match="state_init_fn"):
        tsweep.plan_sweep(markov, ta1.ParamSampler(tfamily_fn(T), None),
                          inputs["w0"], env_sets=inputs["tfam"],
                          fleet_sets=inputs["tfleet"], device="cpu")
    with pytest.raises(ValueError, match="iid"):
        tsweep.plan_sweep(tsweep.SweepSpec(**GRID),
                          ta1.ParamSampler(tfamily_fn(T), None),
                          inputs["w0"], env_sets=inputs["tfam"],
                          fleet_sets=inputs["tfleet"],
                          state_init_fn=lambda p, r: None, device="cpu")
    spec = tsweep.SweepSpec(**GRID)
    sampler = ta1.ParamSampler(tfamily_fn(T), None)
    with pytest.raises(NotImplementedError, match="one card"):
        tsweep.run_sweep(spec, sampler, inputs["w0"], env_sets=inputs["tfam"],
                         fleet_sets=inputs["tfleet"], mesh=object(),
                         device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsweep.plan_sweep(spec, sampler, inputs["w0"],
                              env_sets=inputs["tfam"],
                              fleet_sets=inputs["tfleet"])
