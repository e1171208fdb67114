"""repro_torch.core.td (federated TD(0), Markovian sampling) against
repro.core.td.

Each test of tests/test_td.py, on the port, with the same inputs through
the JAX package where there is a counterpart: initial chain states, walks
and one-hot phi exactly equal, targets at 1e-6 relative, exact TD
quantities equal, whole runs as tests/test_torch_algorithm1.py holds them
(weights 1e-5, decisions exact, ties reported and set aside).  Inside the
port: run_td <-> markov sweep cells bitwise, the walk's draws made many
steps at a time bitwise equal to one step at a time, crash-resume bitwise,
a clean channel equal to none.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import td as jtd  # noqa: E402
from repro.core.algorithm1 import GatedSGDConfig as JCfg  # noqa: E402
from repro.core.algorithm1 import ParamSampler as JPS  # noqa: E402
from repro.core.channel import ChannelSpec as JChan  # noqa: E402
from repro.core.trigger import TriggerConfig as JTrig  # noqa: E402
from repro.experiments import SweepSpec as JSpec  # noqa: E402
from repro.experiments import run_sweep as jrun_sweep  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import algorithm1 as ta1  # noqa: E402
from repro_torch.core import channel as tchan  # noqa: E402
from repro_torch.core import td as ttd  # noqa: E402
from repro_torch.core.trigger import TriggerConfig as TTrig  # noqa: E402
from repro_torch.experiments import run_sweep_resumable  # noqa: E402
from repro_torch.experiments import store as tstore  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402

from test_torch_algorithm1 import (PAIRS, decision_ties,  # noqa: E402
                                   one_thread)  # noqa: F401  (fixture)

TOL, RATE_TOL, TARGET_RTOL = 1e-5, 1e-6, 1e-6
# long loops of tiny ops run on one intra-op thread (one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")
S, M, T, N = 8, 2, 6, 18
W0 = np.zeros(S, np.float32)
JENVS, JFAM = jtd.td_env_family(2, num_states=S)
TENVS, TFAM = ttd.td_env_family(2, num_states=S, device="cpu")
JPARAMS = JENVS[0].agent_params(jnp.asarray(W0), M)
TPARAMS = convert.to_torch(JPARAMS, device="cpu")
GRID = dict(modes=("theoretical", "always"), lambdas=(1e-2,), seeds=(0, 1),
            rhos=(0.999,), eps=0.3, num_iterations=N, num_agents=M,
            random_tx_prob=0.4, sampling="markov", trace="full")


def _tkey(jkey):
    return convert.key_to_torch(jax.random.key_data(jkey), device="cpu")


def _jax_sweep(**kw):
    spec = JSpec(**{**GRID, **kw})
    return spec, jrun_sweep(spec, JPS(jtd.td_family_sampler_fn(T), JPARAMS),
                            jnp.asarray(W0), env_sets=JFAM,
                            state_init_fn=jtd.td_init_states)


def _port_sweep(**kw):
    spec = tsweep.SweepSpec(**{**GRID, **kw})
    return spec, tsweep.run_sweep(
        spec, ta1.ParamSampler(ttd.td_family_sampler_fn(T), TPARAMS), W0,
        env_sets=TFAM, state_init_fn=ttd.td_init_states, device="cpu")


def _cfg(mode, n=N, **kw):
    return dict(trigger=(n,), eps=0.3, num_agents=M, mode=mode,
                random_tx_prob=0.4, **kw)


def _jcfg(mode, n=N, **kw):
    c = _cfg(mode, n, **kw)
    c["trigger"] = JTrig(lam=1e-2, rho=0.999, num_iterations=n)
    return JCfg(**c)


def _tcfg(mode, n=N, **kw):
    c = _cfg(mode, n, **kw)
    c["trigger"] = TTrig(lam=1e-2, rho=0.999, num_iterations=n)
    return ta1.GatedSGDConfig(**c)


# ------------------------------------------------------- chain sampling ----


def test_chain_state_threads_across_batches():
    """The port's walk is the reference's: the same initial states, visited
    states and one-hot phi exactly, targets at 1e-6; the state a batch
    returns is the first state the next batch visits."""
    env, tenv = JENVS[0], TENVS[0]
    jsample = jtd.td_sample_all(env.env_params(), JPARAMS, T)
    tsample = ttd.td_sample_all(tenv.env_params("cpu"), TPARAMS, T)
    js0 = jtd.td_init_states(JPARAMS, jax.random.key(7))
    ts0 = ttd.td_init_states(TPARAMS, trandom.key(7))
    assert ts0.shape == (M,)
    np.testing.assert_array_equal(ts0.numpy(), np.asarray(js0))
    w = np.linspace(-1, 1, S).astype(np.float32)
    jst, tst = js0, ts0.unsqueeze(0)
    for seed in (1, 2):
        jkeys = jax.random.split(jax.random.key(seed), M)
        js1, jphi, jy = jsample(jst, jnp.asarray(w), jkeys)
        ts1, tphi, ty = tsample(tst, torch.from_numpy(w)[None],
                                _tkey(jkeys)[None])
        np.testing.assert_array_equal(tphi[0].numpy(), np.asarray(jphi))
        np.testing.assert_array_equal(ts1[0].numpy(), np.asarray(js1))
        np.testing.assert_allclose(ty[0].numpy(), np.asarray(jy),
                                   rtol=TARGET_RTOL, atol=TARGET_RTOL)
        # the first visited state of the batch IS the incoming chain state
        np.testing.assert_array_equal(tphi[0, :, 0].argmax(-1).numpy(),
                                      tst[0].numpy())
        np.testing.assert_array_equal(tphi.sum(-1).numpy(), np.ones((1, M, T)))
        jst, tst = js1, ts1


def test_chain_steps_follow_transition_support():
    """A 64-step walk from state 0 equals the reference's, and each
    consecutive (s -> s') pair has P_pi[s, s'] > 0."""
    env, tenv = JENVS[0], TENVS[0]
    params = jax.tree.map(lambda x: x[0], JPARAMS)
    _, jphi, _ = jtd.td_family_sampler_fn(64)(
        env.env_params(), params, jnp.asarray(W0), jnp.asarray(0),
        jax.random.key(3))
    tparams = {k: v[:1] for k, v in TPARAMS.items()}
    _, tphi, _ = ttd.td_family_sampler_fn(64)(
        tenv.env_params("cpu"), tparams, torch.zeros(1, S),
        torch.zeros(1, 1, dtype=torch.int64), _tkey(jax.random.key(3))[None, None])
    np.testing.assert_array_equal(tphi[0, 0].numpy(), np.asarray(jphi))
    xs = tphi[0, 0].argmax(-1).numpy()
    P_pi = np.asarray(tenv.transition_matrix()).mean(axis=1)
    for a, b in zip(xs[:-1], xs[1:]):
        assert P_pi[a, b] > 0, (a, b)


def test_walk_draws_at_once_equal_one_step_at_a_time(monkeypatch):
    """The loop draws many steps' walk randomness in one pass; one step a
    pass gives the same run bit for bit."""
    cfg = _tcfg("practical")
    many = ttd.run_td(trandom.key(4), W0, TENVS[1], cfg, T, device="cpu")
    monkeypatch.setattr(ta1, "DRAW_BYTES", 1)
    one = ttd.run_td(trandom.key(4), W0, TENVS[1], cfg, T, device="cpu")
    for name in ("weights", "alphas", "gains", "comm_rate"):
        assert torch.equal(getattr(many, name), getattr(one, name)), name


# ------------------------------------------------------- exact quantities --


def test_stationary_distribution_and_fixed_point_exact():
    env, tenv = JENVS[0], TENVS[0]
    P_pi = np.asarray(env.transition_matrix(), np.float64).mean(axis=1)
    d = ttd.stationary_distribution(P_pi)
    np.testing.assert_array_equal(d, jtd.stationary_distribution(P_pi))
    assert d.min() > 0
    np.testing.assert_allclose(d.sum(), 1.0, atol=1e-12)
    np.testing.assert_allclose(d @ P_pi, d, atol=1e-12)
    wstar = ttd.td_fixed_point(tenv)
    np.testing.assert_array_equal(wstar, jtd.td_fixed_point(env))
    c = np.asarray(tenv.cost_vector(), np.float64)
    np.testing.assert_allclose(wstar, c + tenv.gamma * P_pi @ wstar,
                               atol=1e-9)


def test_td_terms_zero_at_fixed_point():
    """J(w*) == 0 and grad J(w*) == 0; the terms are the reference's."""
    tenv = TENVS[1]
    terms = ttd.td_problem_terms(tenv)
    for got, want in zip(terms, jtd.td_problem_terms(JENVS[1])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wstar = torch.as_tensor(ttd.td_fixed_point(tenv), dtype=torch.float32)
    assert abs(float(terms.objective(wstar))) < 1e-4
    assert float(terms.grad(wstar).abs().max()) < 1e-4
    np.testing.assert_array_equal(TFAM.terms.bvec[1].numpy(),
                                  terms.bvec.numpy())
    for got, want in zip(TFAM.params.values(), JFAM.params.values()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_federated_td_learns():
    """J falls from w0 = 0 and communicating beats never communicating.
    Against the reference at N = 1000: weights at 1e-5; J at 1e-5 of its
    terms' size c0 (J = w'Dw - 2b'w + c0 cancels terms of size c0 ~ 100
    down to ~0.01, so float32 rounding of the terms is what J differs by)."""
    kw = dict(modes=("always", "never"), seeds=(0,), trace="summary",
              num_iterations=1000)
    _, res = _port_sweep(**kw)
    _, ref = _jax_sweep(**kw)
    j0 = float(ttd.td_problem_terms(TENVS[0]).objective(torch.zeros(S)))
    j_always = float(res.j_final[0, 0, 0, 0, 0])
    j_never = float(res.j_final[0, 1, 0, 0, 0])
    assert j_always < 0.01 * j0
    assert j_always < j_never
    np.testing.assert_allclose(res.j_final.numpy(), np.asarray(ref.j_final),
                               rtol=0, atol=TOL * float(TFAM.terms.c0.max()))
    np.testing.assert_allclose(res.trace.final_weights.numpy(),
                               np.asarray(ref.trace.final_weights),
                               rtol=TOL, atol=TOL)


# ------------------------------------------------- per-run <-> sweep -------


@pytest.fixture(scope="module")
def jax_cells():
    return _jax_sweep()[1]


@pytest.mark.parametrize("step,gain", PAIRS)
def test_markov_sweep_matches_reference(jax_cells, step, gain):
    """The whole markov sweep (2 envs x 2 modes x 2 seeds) on every
    backend pair against the reference's: weights 1e-5, decisions exact."""
    spec, res = _port_sweep(step_backend=step, gain_backend=gain)
    ref = jax_cells
    thresholds = np.broadcast_to(spec.thresholds()[0, 0], (8, N))
    ra = np.asarray(ref.trace.alphas).reshape(8, N, M)
    ga = res.trace.alphas.numpy().reshape(8, N, M)
    tied = decision_ties(ga, ra, np.asarray(ref.trace.gains).reshape(8, N, M),
                         thresholds)
    assert not tied
    np.testing.assert_allclose(res.trace.weights.numpy(),
                               np.asarray(ref.trace.weights),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(res.comm_rate.numpy(), np.asarray(ref.comm_rate),
                               rtol=RATE_TOL)


def test_run_td_bitwise_matches_markov_sweep_cells():
    """run_td and the markov sweep share the chain-state key derivation:
    map-batched cells are bitwise, and equal the vmap-batched grid (which
    hands one walk to the two modes of a stream)."""
    spec, res = _port_sweep(batching="map")
    _, vres = _port_sweep()
    assert res.axes == ("env_set", "mode", "lam", "rho", "seed")
    for name in ("weights", "alphas", "gains"):
        assert torch.equal(getattr(res.trace, name),
                           getattr(vres.trace, name)), name
    for e, env in enumerate(TENVS):
        for mi, mode in enumerate(spec.modes):
            for si, seed in enumerate(spec.seeds):
                tr = ttd.run_td(trandom.key(seed), W0, env, _tcfg(mode), T,
                                agent_params=TPARAMS, device="cpu")
                assert torch.equal(res.trace.weights[e, mi, 0, 0, si],
                                   tr.weights), f"env{e} {mode} seed{seed}"
                assert torch.equal(res.trace.alphas[e, mi, 0, 0, si],
                                   tr.alphas)


@pytest.mark.parametrize("trace", ["full", "summary"])
def test_run_td_megastep_parity_per_run(trace):
    """The whole-step kernel serves the TD workload: the port's megastep
    run against the reference's reference-backend run_td."""
    n = 12
    ref = jtd.run_td(jax.random.key(0), jnp.asarray(W0), JENVS[0],
                     _jcfg("practical", n, step_backend="reference"), T)
    got = ttd.run_td(trandom.key(0), W0, TENVS[0],
                     _tcfg("practical", n, step_backend="megastep",
                           gain_backend="kernel"), T, trace=trace,
                     device="cpu")
    w = got.weights[-1] if trace == "full" else got.final_weights
    np.testing.assert_allclose(w.numpy(), np.asarray(ref.weights[-1]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(got.comm_rate), float(ref.comm_rate),
                               rtol=RATE_TOL)
    if trace == "full":
        np.testing.assert_array_equal(got.alphas.numpy(),
                                      np.asarray(ref.alphas))
    else:
        np.testing.assert_array_equal(got.tx_counts.numpy(),
                                      np.asarray(ref.alphas).sum(0))


# ------------------------------------------------------- hash stability ----


def test_sampling_axis_hash_stability():
    """iid drops out of the payload; markov hashes apart."""
    iid = tsweep.SweepSpec(**{**GRID, "sampling": "iid"})
    markov = tsweep.SweepSpec(**GRID)
    assert "sampling" not in tstore.spec_payload(iid)
    assert tstore.spec_payload(markov)["sampling"] == "markov"
    assert tstore.spec_hash(iid) == tstore.spec_hash(
        tsweep.SweepSpec(**{**GRID, "sampling": "iid"}))
    assert tstore.spec_hash(markov) != tstore.spec_hash(iid)
    with pytest.raises(ValueError, match="sampling"):
        tsweep.SweepSpec(**{**GRID, "sampling": "nope"})


def test_markov_sweep_requires_state_init_fn():
    sampler = ta1.ParamSampler(ttd.td_family_sampler_fn(T), TPARAMS)
    with pytest.raises(ValueError, match="state_init_fn"):
        tsweep.plan_sweep(tsweep.SweepSpec(**GRID), sampler, W0,
                          env_sets=TFAM, device="cpu")
    with pytest.raises(ValueError, match="iid"):
        tsweep.plan_sweep(
            tsweep.SweepSpec(**{**GRID, "sampling": "iid",
                                "modes": ("always",)}),
            sampler, W0, env_sets=TFAM, state_init_fn=ttd.td_init_states,
            device="cpu")
    with pytest.raises(TypeError, match="walk"):
        tsweep.plan_sweep(tsweep.SweepSpec(**GRID),
                          ta1.ParamSampler(lambda *a: None, TPARAMS), W0,
                          env_sets=TFAM, state_init_fn=ttd.td_init_states,
                          device="cpu")


# -------------------------------------------------------- crash resume -----


def test_crash_resume_bitwise_over_sampling_axis(tmp_path):
    """Delete the later chunks and resume: each segment rebuilds its chain
    states, so the markov grid is bitwise."""
    kw = dict(trace="summary", chunk_size=2, step_backend="reference")
    spec, ref = _port_sweep(**kw)
    sampler = ta1.ParamSampler(ttd.td_family_sampler_fn(T), TPARAMS)
    d = str(tmp_path / "s")
    run_sweep_resumable(spec, sampler, W0, env_sets=TFAM,
                        state_init_fn=ttd.td_init_states, store_dir=d,
                        device="cpu")
    chunks = sorted(f for f in os.listdir(d) if f.startswith("chunk_"))
    assert len(chunks) == 4
    for f in chunks[2:]:
        os.remove(os.path.join(d, f))
    got = run_sweep_resumable(spec, sampler, W0, env_sets=TFAM,
                              state_init_fn=ttd.td_init_states, store_dir=d,
                              device="cpu")
    assert got.axes == ref.axes
    for name in type(ref.trace)._fields:
        a, b = getattr(got.trace, name), getattr(ref.trace, name)
        if b is None:
            assert a is None
        else:
            assert torch.equal(a, b), f"trace.{name}"


# ------------------------------------------------------- channel model -----


def test_markov_composes_with_channel():
    """Chains + lossy channel: the sampler bootstraps from the agent's
    stale view; against the reference's sweep; the clean row delivers
    every attempt; the per-run channel path equals the sweep's lossy row
    bitwise; a clean channel equals no channel bitwise."""
    kw = dict(modes=("always",), seeds=(0,), batching="map")
    chans = ((0.0, 0, 0), (0.5, 0, 1))
    _, res = _port_sweep(**kw, channel_sets=chans)
    _, ref = _jax_sweep(**kw, channel_sets=tuple(JChan(*c) for c in chans))
    assert "channel" in res.axes
    np.testing.assert_array_equal(res.trace.delivered.numpy(),
                                  np.asarray(ref.trace.delivered))
    np.testing.assert_allclose(res.trace.weights.numpy(),
                               np.asarray(ref.trace.weights),
                               rtol=TOL, atol=TOL)
    ci = res.axes.index("channel")
    alphas = res.trace.alphas.movedim(ci, 0)
    delivered = res.trace.delivered.movedim(ci, 0)
    assert bool((delivered <= alphas).all())
    assert torch.equal(delivered[0], alphas[0])
    chan, caps = tchan.channel_inputs(tchan.ChannelSpec(*chans[1]), M,
                                      device="cpu")
    tr = ttd.run_td(trandom.key(0), W0, TENVS[0], _tcfg("always"), T,
                    agent_params=TPARAMS, channel=chan, channel_caps=caps,
                    device="cpu")
    cell = tuple(1 if n == "channel" else 0 for n in res.axes)
    assert torch.equal(tr.delivered, res.trace.delivered[cell])
    _, none = _port_sweep(**kw)
    clean = tuple(0 if n == "channel" else slice(None) for n in res.axes)
    for name in ("weights", "alphas", "gains"):
        assert torch.equal(getattr(none.trace, name),
                           getattr(res.trace, name)[clean]), name
