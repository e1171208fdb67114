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


@pytest.fixture
def one_thread():
    """One intra-op thread for a test that loops over thousands of tiny
    ops: a small matmul that opens the thread pool costs ~100x more when
    the test workers share the cores (53 us alone, 7.3 ms beside three
    busy processes, 46 us on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("step", ["reference", "fused", "megastep"])
def test_each_step_hands_contiguous_slices(problem, monkeypatch, step):
    """The loop draws many steps in one pass; each step's slices of it
    (samples, random-mode and keep masks) reach the kernel wrappers
    contiguous, as the CUDA kernels require of their inputs."""
    from repro_torch.kernels import gain as K
    p, seen = problem, []
    for name in ("gain_matvec", "practical_gain", "gain_family_stats",
                 "megastep_call"):
        def spy(*args, _real=getattr(K, name), **kw):
            seen.extend(a for a in list(args) + list(kw.values())
                        if torch.is_tensor(a))
            return _real(*args, **kw)
        monkeypatch.setattr(K, name, spy)
    chan, caps = tchannel.channel_inputs(tchannel.ChannelSpec(0.3), M,
                                         device="cpu")
    sampler = ta1.make_sample_all(ta1.ParamSampler(
        p["tenv"].sampler_fn(T), p["tparams"]), M, "cpu")
    ta1.gated_sgd_core(p["tkeys"], torch.from_numpy(p["w0"]),
                       torch.from_numpy(p["modes"]),
                       torch.from_numpy(p["thresholds"]), 0.4, sampler, EPS,
                       M, terms=p["tterms"], gain_backend="kernel",
                       step_backend=step, channel=chan, channel_caps=caps,
                       device="cpu")
    assert len(seen) >= 2 * N
    assert all(t.is_contiguous() for t in seen)


VI_OUTER = 4          # outer steps held against the reference, per call


def _vi_setup():
    jgw, tgw = JGrid(gamma=0.9), TGrid(gamma=0.9)
    prob0 = jgw.vfa_problem(np.zeros(jgw.num_states))
    rho = prob0.min_rho(0.5) * 1.0001
    kw = dict(eps=0.5, num_agents=2, mode="practical")
    return (jgw, tgw, ja1.GatedSGDConfig(trigger=JTrig(1e-4, rho, 200), **kw),
            ta1.GatedSGDConfig(trigger=TTrig(1e-4, rho, 200), **kw,
                               step_backend="megastep", gain_backend="kernel"),
            JTrig(1e-4, rho, 200))


def _hold_vi(tw, ttraces, jw, jtraces, trig):
    """The port's outer loop against the reference's, step by step."""
    thr = np.asarray(trig.schedule())[None]
    for i, (tt, jt) in enumerate(zip(ttraces, jtraces)):
        assert not decision_ties(tt.alphas[None].numpy(),
                                 np.asarray(jt.alphas)[None],
                                 np.asarray(jt.gains)[None], thr), i
        np.testing.assert_allclose(tt.weights.numpy(), np.asarray(jt.weights),
                                   rtol=TOL, atol=TOL, err_msg=f"outer {i}")
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("form", ["loop", "scan"])
def test_value_iteration_matches_reference(form):
    """run_value_iteration (closure samplers, tests/test_algorithm1.py:159)
    and run_value_iteration_scan (stacked params rebuilt from V and the
    exact terms, tests/test_sweep.py:338) against the reference's, on the
    discounted gridworld, for VI_OUTER outer steps of 200 inner."""
    jgw, tgw, jcfg, tcfg, trig = _vi_setup()
    if form == "loop":
        jw, jtr = ja1.run_value_iteration(
            jax.random.key(0), jnp.zeros(25),
            lambda vw: jgw.make_sampler(vw, 20), jcfg, num_outer=VI_OUTER)
        tw, ttr = ta1.run_value_iteration(
            trandom.key(0), torch.zeros(25),
            lambda vw: tgw.make_sampler(vw, 20), tcfg, num_outer=VI_OUTER,
            device="cpu")
    else:
        jw, jst = ja1.run_value_iteration_scan(
            jax.random.key(0), jnp.zeros(25), jgw.sampler_fn(20),
            lambda v: jgw.agent_params(v, 2), jcfg, num_outer=VI_OUTER,
            terms_for_v=jgw.problem_terms)
        tw, tst = ta1.run_value_iteration_scan(
            trandom.key(0), torch.zeros(25), tgw.sampler_fn(20),
            lambda v: tgw.agent_params(v, 2), tcfg, num_outer=VI_OUTER,
            terms_for_v=tgw.problem_terms, device="cpu")
        assert tst.comm_rate.shape == (VI_OUTER,)
        assert tst.weights.shape == (VI_OUTER, 201, 25)
        jtr = [ja1.InnerTrace(*(None if x is None else x[i] for x in jst))
               for i in range(VI_OUTER)]
        ttr = [ta1.InnerTrace(*(None if x is None else x[i] for x in tst))
               for i in range(VI_OUTER)]
    _hold_vi(tw, ttr, jw, jtr, trig)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("form", ["loop", "scan"])
def test_outer_value_iteration_approaches_true_value(form):
    """The reference tests' own setting on the port (40 outer x 200 inner,
    T = 20, practical): within 15 % of V_pi's scale."""
    _, tgw, _, tcfg, _ = _vi_setup()
    v_true = tgw.exact_value()
    if form == "loop":
        w, traces = ta1.run_value_iteration(
            trandom.key(0), torch.zeros(25),
            lambda vw: tgw.make_sampler(vw, 20), tcfg, num_outer=40,
            device="cpu")
        rates = torch.stack([t.comm_rate for t in traces])
    else:
        w, traces = ta1.run_value_iteration_scan(
            trandom.key(0), torch.zeros(25), tgw.sampler_fn(20),
            lambda v: tgw.agent_params(v, 2), tcfg, num_outer=40,
            terms_for_v=tgw.problem_terms, device="cpu")
        rates = traces.comm_rate
    err0 = float(np.max(np.abs(v_true)))
    err = float(np.max(np.abs(w.numpy() - v_true)))
    assert err < 0.15 * err0, (err, err0)
    assert rates.shape == (40,)
    assert bool(((rates >= 0) & (rates <= 1)).all())


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
    # the reference's own refusals of the slice's new surface
    from repro_torch.experiments import sweep as tsweep
    with pytest.raises(ValueError, match="sampling"):
        tsweep.SweepSpec(modes=("always",), lambdas=(1e-2,), seeds=(0,),
                         rhos=(0.9,), eps=0.1, num_iterations=N,
                         num_agents=M, sampling="nope")
    cfg = ta1.GatedSGDConfig(trigger=TTrig(1e-2, 0.9, 4), eps=0.1,
                             num_agents=M, mode="theoretical")
    with pytest.raises(ValueError, match="terms_for_v"):
        ta1.run_value_iteration_scan(trandom.key(0), torch.zeros(S),
                                     lambda p, r: None, lambda v: {}, cfg,
                                     num_outer=1, device="cpu")
    if not torch.cuda.is_available():
        kw.pop("device")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ta1.gated_sgd_core(**kw)
