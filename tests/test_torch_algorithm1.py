"""repro_torch.core.algorithm1 against the reference's oracle.

The port's ``gated_sgd_core`` runs all six modes as six runs of one batch,
under every (step, gain) backend pair of the port, against the reference's
``gated_sgd_core`` with its reference step and gain backends (vmapped over
the same six runs): weights and gains at 1e-5, decisions and tx_counts
exact.  A decision may flip only where the oracle's gain sits within 1e-5
of -lambda_k (ROADMAP queue 3 item 3); such runs are reported and set
aside, and none occurs on these inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import algorithm1 as ja1  # noqa: E402
from repro.core.trigger import TriggerConfig as JTrig  # noqa: E402
from repro.envs import garnet as jgarnet  # noqa: E402
from repro.envs.gridworld import GridWorld as JGrid  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import algorithm1 as ta1  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core.trigger import TriggerConfig as TTrig  # noqa: E402
from repro_torch.envs import garnet as tgarnet  # noqa: E402
from repro_torch.envs.gridworld import GridWorld as TGrid  # noqa: E402

TOL = 1e-5
RATE_TOL = 1e-6
PAIRS = [(s, g) for s in ("reference", "fused", "megastep")
         for g in ("reference", "kernel")]
S, M, T, N, EPS = 8, 3, 6, 12, 1.0


def decision_ties(got_alphas, ref_alphas, ref_gains, thresholds):
    """Runs whose decisions differ from the oracle's: each first flip must
    sit at a tie (|gain + lambda_k| <= 1e-5 (|gain| + 1)); returns the
    tied runs (leading axis of (runs, N, m) inputs) to leave out."""
    got_alphas, ref_alphas = np.asarray(got_alphas), np.asarray(ref_alphas)
    ref_gains, thresholds = np.asarray(ref_gains), np.asarray(thresholds)
    tied = []
    for r in range(got_alphas.shape[0]):
        diff = got_alphas[r] != ref_alphas[r]
        if not diff.any():
            continue
        k = int(np.argmax(diff.any(axis=-1)))
        g = ref_gains[r, k][diff[k]]
        margin = np.abs(g + thresholds[r, k]) / (np.abs(g) + 1.0)
        assert margin.max() <= TOL, f"run {r} step {k}: real decision flip"
        tied.append(r)
    return tied


@pytest.fixture(scope="module")
def problem():
    w0 = np.zeros(S, np.float32)
    jenv = jgarnet.GarnetMDP(num_states=S, seed=2)
    tenv = tgarnet.GarnetMDP(num_states=S, seed=2)
    jparams = jgarnet.garnet_fleet_sets([jenv], w0, M, num_junk=1)
    jparams = jax.tree.map(lambda x: x[0], jparams)
    tparams = convert.to_torch(jparams, device="cpu")
    jterms = ja1.ProblemTerms.from_problem(jenv.vfa_problem(w0))
    thresholds = np.stack([np.asarray(JTrig(lam, 0.95, N).schedule())
                           for lam in (1e-3, 1e-2, 1e-3, 1e-2, 1e-3, 1e-2)])
    jkeys = jax.random.split(jax.random.key(5), 6)
    return dict(w0=w0, jenv=jenv, tenv=tenv, jparams=jparams,
                tparams=tparams, jterms=jterms,
                tterms=convert.to_torch(jterms, device="cpu"), thresholds=thresholds,
                jkeys=jkeys,
                tkeys=convert.key_to_torch(jax.random.key_data(jkeys), device="cpu"),
                modes=np.arange(6))


@pytest.fixture(scope="module")
def oracle(problem):
    p = problem
    fn = p["jenv"].sampler_fn(T)

    def one(key, mode, thr):
        return ja1.gated_sgd_core(
            key, jnp.asarray(p["w0"]), mode, thr, 0.4,
            lambda rngs: jax.vmap(fn)(p["jparams"], rngs), EPS, M,
            terms=p["jterms"], gain_backend="reference", trace="full",
            step_backend="reference")
    return jax.vmap(one)(p["jkeys"], jnp.asarray(p["modes"]),
                         jnp.asarray(p["thresholds"]))


def _port(problem, trace, step, gain):
    p = problem
    fn = p["tenv"].sampler_fn(T)
    params = p["tparams"]
    return ta1.gated_sgd_core(
        p["tkeys"], torch.from_numpy(p["w0"]), torch.from_numpy(p["modes"]),
        torch.from_numpy(p["thresholds"]), 0.4,
        lambda rngs: fn({k: v.expand((rngs.shape[0],) + v.shape)
                         for k, v in params.items()}, rngs),
        EPS, M, terms=p["tterms"], gain_backend=gain, trace=trace,
        step_backend=step, device="cpu")


@pytest.mark.parametrize("step,gain", PAIRS)
def test_core_full_trace_all_modes(problem, oracle, step, gain):
    ref = oracle
    got = _port(problem, "full", step, gain)
    tied = decision_ties(got.alphas, ref.alphas, ref.gains,
                         problem["thresholds"])
    keep = [r for r in range(6) if r not in tied]
    assert not tied
    np.testing.assert_array_equal(got.alphas.numpy()[keep],
                                  np.asarray(ref.alphas)[keep])
    for name in ("weights", "gains"):
        np.testing.assert_allclose(getattr(got, name).numpy()[keep],
                                   np.asarray(getattr(ref, name))[keep],
                                   rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.comm_rate.numpy(), np.asarray(ref.comm_rate),
                               rtol=RATE_TOL)
    assert 0 < float(got.comm_rate[:3].mean()) < 1   # gated modes do split


@pytest.mark.parametrize("step,gain", PAIRS)
def test_core_summary_trace_all_modes(problem, oracle, step, gain):
    """The summary trace against the full oracle, reduced over steps."""
    ref = oracle
    got = _port(problem, ta1.TraceSpec(j_trajectory=True, alphas=True),
                step, gain)
    assert not decision_ties(got.alphas, ref.alphas, ref.gains,
                             problem["thresholds"])
    alphas, gains = np.asarray(ref.alphas), np.asarray(ref.gains)
    np.testing.assert_array_equal(got.tx_counts.numpy(), alphas.sum(axis=1))
    terms = ta1.ProblemTerms(*problem["tterms"])
    weights = torch.from_numpy(np.array(ref.weights))
    for name, want in (("final_weights", weights[:, -1]),
                       ("gain_mean", gains.mean(axis=1)),
                       ("gain_min", gains.min(axis=1)),
                       ("gain_max", gains.max(axis=1)),
                       ("j_final", terms.objective(weights[:, -1])),
                       ("j_trajectory", terms.objective(weights[:, 1:]))):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.comm_rate.numpy(), np.asarray(ref.comm_rate),
                               rtol=RATE_TOL)


def test_single_run_equals_its_row_of_the_batch(problem):
    """A (2,) key runs one run, the same as that run's row of a batch."""
    batch = _port(problem, "full", "megastep", "kernel")
    p = problem
    fn = p["tenv"].sampler_fn(T)
    for r in (0, 3):
        one = ta1.gated_sgd_core(
            p["tkeys"][r], torch.from_numpy(p["w0"]), r,
            torch.from_numpy(p["thresholds"][r]), 0.4,
            lambda rngs: fn({k: v.expand((rngs.shape[0],) + v.shape)
                             for k, v in p["tparams"].items()}, rngs),
            EPS, M, terms=p["tterms"], step_backend="megastep",
            gain_backend="kernel", device="cpu")
        assert one.weights.shape == (N + 1, S)
        for name in ("weights", "alphas", "gains", "comm_rate"):
            torch.testing.assert_close(getattr(one, name),
                                       getattr(batch, name)[r],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["theoretical"])
def test_run_gated_sgd_and_metric(mode):
    """The per-run API on the paper's gridworld, closure sampler."""
    jenv, tenv = JGrid(), TGrid()
    v = np.asarray(jenv.exact_value(), np.float32) * 0.5
    jprob, tprob = jenv.vfa_problem(v), tenv.vfa_problem(v)
    eps = 0.5 * jprob.max_stable_stepsize()
    kw = dict(eps=eps, num_agents=2, mode=mode)
    jcfg = ja1.GatedSGDConfig(trigger=JTrig(1e-2, 0.9, 10), **kw,
                              gain_backend="reference",
                              step_backend="reference")
    tcfg = ta1.GatedSGDConfig(trigger=TTrig(1e-2, 0.9, 10), **kw,
                              gain_backend="kernel", step_backend="megastep")
    ref = ja1.run_gated_sgd(jax.random.key(3), jnp.zeros(25),
                            jenv.make_sampler(jnp.asarray(v), 8), jcfg,
                            problem=jprob)
    got = ta1.run_gated_sgd(trandom.key(3), torch.zeros(25),
                            tenv.make_sampler(v, 8), tcfg, problem=tprob,
                            device="cpu")
    np.testing.assert_array_equal(got.alphas.numpy(), np.asarray(ref.alphas))
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(ta1.performance_metric(got, 1e-2, tprob)),
        float(ja1.performance_metric(ref, 1e-2, jprob)), rtol=TOL)


def test_config_validation_and_refusals(problem):
    with pytest.raises(ValueError):
        ta1.GatedSGDConfig(trigger=TTrig(1e-2, 0.9, 4), eps=0.1,
                           num_agents=2, gain_backend="pallas")
    with pytest.raises(ValueError):
        ta1.resolve_trace("everything")
    kw = dict(rng=trandom.key(0), w0=torch.zeros(S), mode_id=1,
              thresholds=torch.zeros(N), tx_prob=0.5,
              sample_all=lambda r: None, eps=0.1, num_agents=M,
              device="cpu")
    chan, _ = tchannel.channel_inputs(tchannel.ChannelSpec(delay=1), M,
                                      device="cpu")
    with pytest.raises(NotImplementedError, match="delay"):
        ta1.gated_sgd_core(**kw, step_backend="megastep", channel=chan,
                           channel_caps=(2, 1))
    with pytest.raises(ValueError, match="channel_caps"):
        ta1.gated_sgd_core(**kw, channel=chan)
    with pytest.raises(NotImplementedError, match="item 8"):
        ta1.gated_sgd_core(**kw, sampler_state=torch.zeros(M))
    if not torch.cuda.is_available():
        kw.pop("device")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ta1.gated_sgd_core(**kw)
