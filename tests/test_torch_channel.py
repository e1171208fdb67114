"""repro_torch's lossy-edge channel against repro's.

The same numpy inputs go through ``repro``'s channel core (its reference
step and gain backends, the oracle) and the port's on every step backend:
weights at 1e-5, gains at 1e-5 of their run's largest gain (ROADMAP queue
3 item 4), attempted and delivered decisions exact with ties reported
(``decision_ties``) and set aside, comm and delivered rates at 1e-6.
Inside the port a clean ``ChannelSpec()`` row is the ``channel=None``
result bit for bit, and megastep refuses a delay.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import algorithm1 as ja1  # noqa: E402
from repro.core import channel as jchan  # noqa: E402
from repro.core.algorithm1 import ParamSampler as JPS  # noqa: E402
from repro.envs import family_sampler_fn as jfamily_fn  # noqa: E402
from repro.experiments import sweep as jsweep  # noqa: E402

from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import algorithm1 as ta1  # noqa: E402
from repro_torch.core import channel as tchan  # noqa: E402
from repro_torch.envs import family_sampler_fn as tfamily_fn  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402

from test_torch_algorithm1 import (EPS, M, N, decision_ties,  # noqa: E402
                                   problem)  # noqa: F401  (fixture)
from test_torch_sweep import GRID, T, _close_gains, inputs  # noqa: E402,F401

TOL, RATE_TOL = 1e-5, 1e-6

# name -> (drop_prob, delay, staleness); M = 3 agents
CHANNELS = {
    "drop": (0.3, 0, 0),
    "per-agent-drop": ((0.0, 0.5, 0.9), 0, 0),
    "delay": (0.0, 2, 0),
    "stale": (0.0, 0, 3),
    "combined": ((0.1, 0.3, 0.6), 2, 3),
}
CORE_CASES = [(c, trace, step) for c in CHANNELS
              for trace in ("full", "summary")
              for step in ("reference", "fused", "megastep")
              if not (step == "megastep" and CHANNELS[c][1] > 0)]


# ------------------------------------------------------------- the spec --

SPEC_CASES = [
    {"drop_prob": 0.1, "delay": 2},
    (0.2,),
    (0.0, 1, 4),
    [[0.1, 0.3, 0.5], 0, 1],
    {"drop_prob": [0.1, 0.3, 0.5]},
    (1.5,),
    (-0.1,),
    ("lossy",),
    ((0.1, 0.2),),
    (0.0, -1),
    (0.0, 0, True),
    (0.0, 1.5),
]


@pytest.mark.parametrize("raw", SPEC_CASES)
def test_spec_coercion_and_validation_parity(raw):
    """as_spec / validate_channel give the reference's spec or its error."""
    def outcome(mod):
        try:
            return tuple(mod.validate_channel(mod.as_spec(raw), M))
        except ValueError as e:
            return ("ValueError", str(e))
    assert outcome(tchan) == outcome(jchan)
    assert tchan.as_spec(raw) == jchan.as_spec(raw)


def test_caps_and_stacking_match_reference():
    specs = [tchan.ChannelSpec(), tchan.ChannelSpec(0.3, 2, 5),
             tchan.ChannelSpec((0.1, 0.2, 0.7), 1, 0)]
    jspecs = [jchan.ChannelSpec(*s) for s in specs]
    assert tchan.channel_caps(specs) == jchan.channel_caps(jspecs) == (3, 6)
    got = tchan.stack_channels(specs, M, device="cpu")
    want = jchan.stack_channels(jspecs, M)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    one, caps = tchan.channel_inputs(specs[2], M, device="cpu")
    jone, jcaps = jchan.channel_inputs(jspecs[2], M)
    assert caps == jcaps == (2, 1)
    for a, b in zip(one, jone):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tchan.PERFECT == tchan.ChannelSpec() == (0.0, 0, 0)


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 0.97, 1.0])
def test_keep_mask_bits_match_jax(p):
    """bernoulli(fold_in(rng_k, 1), 1 - p, (m,)), as the reference draws it."""
    jkeys = jax.random.split(jax.random.key(11), 64)
    drop = np.full((64, 5), p, np.float32)
    drop[:, 1] = 0.3
    want = jax.vmap(lambda k, d: jax.random.bernoulli(
        jax.random.fold_in(k, 1), 1.0 - d, (5,)))(jkeys, jnp.asarray(drop))
    tkeys = torch.from_numpy(
        np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    got = trandom.bernoulli(trandom.fold_in(tkeys, 1),
                            1.0 - torch.from_numpy(drop), (5,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- the core --


@pytest.fixture(scope="module")
def core_oracle(problem):  # noqa: F811
    """The reference's channel core (reference backends), vmapped over the
    six runs of ``problem``, per channel and trace."""
    p, cache = problem, {}
    fn = p["jenv"].sampler_fn(T_CORE)

    def get(name, trace):
        if (name, trace) not in cache:
            chan, caps = jchan.channel_inputs(jchan.ChannelSpec(*CHANNELS[name]), M)

            def one(key, mode, thr):
                return ja1.gated_sgd_core(
                    key, jnp.asarray(p["w0"]), mode, thr, 0.4,
                    lambda rngs: jax.vmap(fn)(p["jparams"], rngs), EPS, M,
                    terms=p["jterms"], gain_backend="reference",
                    trace=(ja1.TraceSpec(alphas=True, gains=True)
                           if trace == "summary" else "full"),
                    step_backend="reference", channel=chan,
                    channel_caps=caps)
            cache[name, trace] = jax.vmap(one)(
                p["jkeys"], jnp.asarray(p["modes"]),
                jnp.asarray(p["thresholds"]))
        return cache[name, trace]
    return get


T_CORE = 6      # tests/test_torch_algorithm1.py's T


def _port_core(problem, name, trace, step):  # noqa: F811
    p = problem
    fn = p["tenv"].sampler_fn(T_CORE)
    chan, caps = tchan.channel_inputs(tchan.ChannelSpec(*CHANNELS[name]), M,
                                      device="cpu")
    return ta1.gated_sgd_core(
        p["tkeys"], torch.from_numpy(p["w0"]), torch.from_numpy(p["modes"]),
        torch.from_numpy(p["thresholds"]), 0.4,
        lambda rngs: fn({k: v.expand((rngs.shape[0],) + v.shape)
                         for k, v in p["tparams"].items()}, rngs),
        EPS, M, terms=p["tterms"], gain_backend="kernel",
        trace=(ta1.TraceSpec(alphas=True, gains=True)
               if trace == "summary" else "full"),
        step_backend=step, channel=chan, channel_caps=caps, device="cpu")


@pytest.mark.parametrize("name,trace,step", CORE_CASES)
def test_core_matches_reference(problem, core_oracle, name, trace, step):  # noqa: F811
    ref = core_oracle(name, trace)
    got = _port_core(problem, name, trace, step)
    tied = decision_ties(got.alphas, ref.alphas, ref.gains,
                         problem["thresholds"])
    assert not tied, f"tie flips in runs {tied}"
    np.testing.assert_array_equal(got.alphas.numpy(), np.asarray(ref.alphas))
    gains = np.asarray(ref.gains)
    scale = np.abs(gains).max(axis=(1, 2), keepdims=True) + 1.0
    assert np.all(np.abs(got.gains.numpy() - gains) <= TOL * scale)
    np.testing.assert_allclose(got.comm_rate.numpy(), np.asarray(ref.comm_rate),
                               rtol=RATE_TOL, atol=RATE_TOL)
    if trace == "full":
        np.testing.assert_array_equal(got.delivered.numpy(),
                                      np.asarray(ref.delivered))
        np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                                   rtol=TOL, atol=TOL)
        assert bool((got.delivered <= got.alphas).all())
        return
    np.testing.assert_array_equal(got.delivered_counts.numpy(),
                                  np.asarray(ref.delivered_counts))
    np.testing.assert_array_equal(got.tx_counts.numpy(),
                                  np.asarray(ref.tx_counts))
    np.testing.assert_allclose(got.delivered_rate.numpy(),
                               np.asarray(ref.delivered_rate),
                               rtol=RATE_TOL, atol=RATE_TOL)
    for field in ("final_weights", "j_final"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)),
                                   rtol=TOL, atol=TOL)
    for field in ("gain_mean", "gain_min", "gain_max"):
        assert np.all(np.abs(getattr(got, field).numpy()
                             - np.asarray(getattr(ref, field)))
                      <= TOL * scale[:, 0])


def test_drop_one_delivers_nothing_and_freezes_weights(problem):  # noqa: F811
    """drop 1: every attempt counts, none lands, w stays w0."""
    p = problem
    fn = p["tenv"].sampler_fn(T_CORE)
    chan, caps = tchan.channel_inputs(tchan.ChannelSpec(1.0), M, device="cpu")
    got = ta1.gated_sgd_core(
        p["tkeys"], torch.from_numpy(p["w0"]), torch.from_numpy(p["modes"]),
        torch.from_numpy(p["thresholds"]), 0.4,
        lambda rngs: fn({k: v.expand((rngs.shape[0],) + v.shape)
                         for k, v in p["tparams"].items()}, rngs),
        EPS, M, terms=p["tterms"], trace="summary", channel=chan,
        channel_caps=caps, device="cpu")
    assert float(got.delivered_rate.abs().max()) == 0.0
    assert float(got.comm_rate[4]) == 1.0            # "always" still attempts
    np.testing.assert_array_equal(got.final_weights.numpy(),
                                  np.broadcast_to(p["w0"], (6, len(p["w0"]))))


def test_core_refuses_megastep_with_delay(problem, monkeypatch):  # noqa: F811
    kw = dict(rng=trandom.key(0), w0=torch.zeros(4), mode_id=1,
              thresholds=torch.zeros(N), tx_prob=0.5,
              sample_all=lambda r: None, eps=0.1, num_agents=M,
              device="cpu")
    chan, caps = tchan.channel_inputs(tchan.ChannelSpec(delay=1), M,
                                      device="cpu")
    with pytest.raises(NotImplementedError, match="delay"):
        ta1.gated_sgd_core(**kw, step_backend="megastep", channel=chan,
                           channel_caps=caps)
    # the env-resolved default step backend is megastep: refused too
    monkeypatch.delenv("REPRO_TORCH_STEP_BACKEND", raising=False)
    with pytest.raises(NotImplementedError, match="delay"):
        ta1.gated_sgd_core(**kw, channel=chan, channel_caps=caps)
    with pytest.raises(ValueError, match="channel_caps"):
        ta1.gated_sgd_core(**kw, step_backend="fused", channel=chan)


# ------------------------------------------------------------ the sweep --

SWEEP_CHANNELS = (tchan.ChannelSpec(), tchan.ChannelSpec(0.3),
                  tchan.ChannelSpec((0.0, 0.5, 0.9), 0, 2),
                  tchan.ChannelSpec(0.2, 1, 0), tchan.ChannelSpec(0.0, 3, 1))


def _sweep(inputs, channels, step, trace, **kw):  # noqa: F811
    spec = tsweep.SweepSpec(**GRID, step_backend=step, gain_backend="kernel",
                            trace=trace, channel_sets=channels, **kw)
    return spec, tsweep.run_sweep(spec, ta1.ParamSampler(tfamily_fn(T), None),
                                  inputs["w0"], env_sets=inputs["tfam"],
                                  fleet_sets=inputs["tfleet"], device="cpu")


@pytest.fixture(scope="module")
def sweep_oracle(inputs):  # noqa: F811
    spec = jsweep.SweepSpec(
        **GRID, step_backend="reference", gain_backend="reference",
        trace=ja1.TraceSpec(alphas=True, gains=True),
        channel_sets=tuple(jchan.ChannelSpec(*c) for c in SWEEP_CHANNELS))
    return jsweep.run_sweep(spec, JPS(jfamily_fn(T), None),
                            jnp.asarray(inputs["w0"]),
                            env_sets=inputs["jfam"],
                            fleet_sets=inputs["jfleet"])


@pytest.mark.parametrize("step", ["reference", "fused", "megastep"])
def test_channel_sweep_matches_reference(inputs, sweep_oracle, step):  # noqa: F811
    """The whole channel-axis sweep; megastep takes the delay-free rows."""
    rows = [i for i, c in enumerate(SWEEP_CHANNELS)
            if step != "megastep" or c.delay == 0]
    spec, got = _sweep(inputs, tuple(SWEEP_CHANNELS[i] for i in rows), step,
                       ta1.TraceSpec(alphas=True, gains=True))
    assert got.axes == sweep_oracle.axes == (
        "env_set", "channel") + tsweep.BASE_AXES
    tr = got.trace
    rt = jax.tree.map(lambda x: np.asarray(x)[:, rows], sweep_oracle.trace)
    ga = tr.alphas.numpy().reshape(-1, N_SWEEP, M)
    ra = rt.alphas.reshape(-1, N_SWEEP, M)
    thr = np.broadcast_to(
        spec.thresholds()[None, None, None, :, :, None, :],
        got.comm_rate.shape + (N_SWEEP,)).reshape(-1, N_SWEEP)
    assert not decision_ties(ga, ra, rt.gains.reshape(-1, N_SWEEP, M), thr)
    np.testing.assert_array_equal(ga, ra)
    np.testing.assert_array_equal(tr.delivered_counts.numpy(),
                                  rt.delivered_counts)
    np.testing.assert_array_equal(tr.tx_counts.numpy(), rt.tx_counts)
    for field in ("comm_rate", "delivered_rate"):
        np.testing.assert_allclose(getattr(tr, field).numpy(),
                                   getattr(rt, field), rtol=RATE_TOL,
                                   atol=RATE_TOL)
    np.testing.assert_allclose(tr.final_weights.numpy(), rt.final_weights,
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tr.j_final.numpy(), rt.j_final, rtol=1e-4,
                               atol=TOL)
    _close_gains(tr.gains.numpy(), rt.gains)


N_SWEEP = GRID["num_iterations"]


@pytest.mark.parametrize("step", ["reference", "fused", "megastep"])
@pytest.mark.parametrize("trace", ["full", "summary"])
def test_clean_channel_equals_no_channel_bitwise(inputs, step, trace):  # noqa: F811
    """(ChannelSpec(),) gives the channel=None sweep bit for bit, and
    delivers every attempt."""
    _, none = _sweep(inputs, None, step, trace)
    _, clean = _sweep(inputs, (tchan.ChannelSpec(),), step, trace)
    assert clean.axes == ("env_set", "channel") + tsweep.BASE_AXES
    for name, a in none.trace._asdict().items():
        b = getattr(clean.trace, name)
        if name.startswith("delivered"):
            assert a is None and b is not None
        elif a is None:
            assert b is None
        else:
            assert torch.equal(b.squeeze(1), a), name
    if trace == "full":
        assert torch.equal(clean.trace.delivered, clean.trace.alphas)
    else:
        assert torch.equal(clean.trace.delivered_counts,
                           clean.trace.tx_counts)
        assert torch.equal(clean.trace.delivered_rate, clean.trace.comm_rate)


def test_per_run_core_equals_its_sweep_cell(inputs):  # noqa: F811
    """One run of the core with one channel = that cell of the sweep."""
    spec, res = _sweep(inputs, SWEEP_CHANNELS, "fused", "full")
    fam, fleets = inputs["tfam"], inputs["tfleet"]
    fn = tfamily_fn(T)
    for e, c, mi, li, si in ((0, 4, 0, 1, 1), (1, 2, 3, 0, 0)):
        env = {k: v[e] for k, v in fam.params.items()}
        params = {k: v[e] for k, v in fleets.items()}
        chan, _ = tchan.channel_inputs(SWEEP_CHANNELS[c], M, device="cpu")
        one = ta1.gated_sgd_core(
            trandom.key(spec.seeds[si]), torch.from_numpy(inputs["w0"]),
            ta1.MODE_IDS[spec.modes[mi]],
            torch.from_numpy(spec.thresholds()[li, 0]), GRID["random_tx_prob"],
            lambda rngs: fn({k: v.expand((rngs.shape[0],) + v.shape)
                             for k, v in env.items()},
                            {k: v.expand((rngs.shape[0],) + v.shape)
                             for k, v in params.items()}, rngs),
            spec.eps, M, terms=ta1.ProblemTerms(*(t[e] for t in fam.terms)),
            gain_backend="kernel", trace="full", step_backend="fused",
            channel=chan, channel_caps=tchan.channel_caps(SWEEP_CHANNELS),
            device="cpu")
        cell = (e, c, mi, li, 0, si)
        for name in ("weights", "alphas", "delivered"):
            torch.testing.assert_close(getattr(one, name),
                                       getattr(res.trace, name)[cell],
                                       rtol=1e-6, atol=1e-6)


def test_sweep_spec_channel_validation():
    with pytest.raises(ValueError, match="non-empty"):
        tsweep.SweepSpec(**GRID, channel_sets=())
    with pytest.raises(ValueError, match="megastep.*delay"):
        tsweep.SweepSpec(**GRID, step_backend="megastep",
                         channel_sets=(tchan.ChannelSpec(delay=1),))
    with pytest.raises(ValueError, match="3 agents"):
        tsweep.SweepSpec(**GRID, channel_sets=(tchan.ChannelSpec((0.1,)),))
    spec = tsweep.SweepSpec(**GRID, step_backend="megastep",
                            channel_sets=({"drop_prob": [0.1, 0.2, 0.3],
                                           "staleness": 2},))
    assert spec.channel_sets == (tchan.ChannelSpec((0.1, 0.2, 0.3), 0, 2),)
