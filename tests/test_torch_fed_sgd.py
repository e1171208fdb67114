"""repro_torch.core.fed_sgd against repro.core.fed_sgd.

``tree_vdot`` / ``tree_bytes``; the ``threshold`` schedule within the one
ulp of ROADMAP queue 3 item 6 (XLA's float32 ``pow`` against a correctly
rounded ``rho**e``); ``local_gain`` under both estimators on a small MLP
and on reduced mamba2-370m with the reference's parameters, within 1e-5
of the gain's scale (queue 3 item 4: a gain is a difference of terms of
size eps ||g||^2); the ``hvp_subsample`` check of
tests/test_perf_variants.py on the port; and ``gated_psum_mean`` /
``gate_and_aggregate`` for 4 agents against the reference under
``jax.vmap(..., axis_name=...)``, where ``psum`` sums over the mapped
agents, with ``agg_dtype="bfloat16"`` and with nobody transmitting.

On reduced mamba2-370m the reference's ``tree_vdot`` is itself off: XLA's
float32 dot on the CPU accumulates a leaf of 5e5 values to ~2e-4
relative.  The port is held there against the reference's gradient and
Hessian-vector product trees (``jax.grad`` and ``jax.jvp``), with the
dots taken in float64; the reference's own gain is held at 1e-3 of scale.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import fed_sgd as jfed  # noqa: E402
from repro.data.synthetic_lm import SyntheticLMConfig, make_lm_batch  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_from_jax, state_dict_to_jax  # noqa: E402
from repro_torch.core import fed_sgd as tfed  # noqa: E402
from repro_torch.core import gain_dispatch as tgd  # noqa: E402
from repro_torch.optim import clip_by_global_norm as tclip  # noqa: E402

GAIN_TOL = 1e-5        # of the gain's scale (ROADMAP queue 3 item 4)
REF_VDOT_TOL = 1e-3    # the reference's own float32 vdot at 5e5 values
AGENTS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool spinning beside them costs more than it gains at these
    sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# a small MLP, shared numpy data
# ---------------------------------------------------------------------------

def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (0.5 * rng.normal(size=(6, 12))).astype(np.float32),
            "b1": (0.1 * rng.normal(size=(12,))).astype(np.float32),
            "w2": (0.5 * rng.normal(size=(12, 1))).astype(np.float32)}


def _mlp_data(seed, n=32):
    rng = np.random.default_rng(100 + seed)
    return (rng.normal(size=(n, 6)).astype(np.float32),
            rng.normal(size=(n,)).astype(np.float32))


def _jloss(X, y):
    def loss(p):
        h = jnp.tanh(X @ p["w1"] + p["b1"])
        return jnp.mean(((h @ p["w2"])[:, 0] - y) ** 2)
    return loss


def _tloss(X, y):
    X, y = torch.from_numpy(X), torch.from_numpy(y)

    def loss(p):
        h = torch.tanh(X @ p["w1"] + p["b1"])
        return torch.mean(((h @ p["w2"])[:, 0] - y) ** 2)
    return loss


def _tparams(p):
    return {k: torch.from_numpy(np.array(v)).requires_grad_(True)
            for k, v in p.items()}


def _scale(g, hg, eps):
    """The size of the terms a gain is built from (float64)."""
    gg = sum(float(np.vdot(np.asarray(g[k], np.float64),
                           np.asarray(g[k], np.float64))) for k in g)
    ghg = sum(float(np.vdot(np.asarray(g[k], np.float64),
                            np.asarray(hg[k], np.float64))) for k in g)
    return eps * gg + 0.5 * eps**2 * abs(ghg), -eps * gg + 0.5 * eps**2 * ghg


# ---------------------------------------------------------------------------
# tree helpers and the threshold schedule
# ---------------------------------------------------------------------------

def test_tree_vdot_and_bytes():
    a, b = _mlp_params(1), _mlp_params(2)
    want = float(jfed.tree_vdot({k: jnp.asarray(v) for k, v in a.items()},
                                {k: jnp.asarray(v) for k, v in b.items()}))
    got = tfed.tree_vdot(_tparams(a), _tparams(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    assert tfed.tree_bytes(_tparams(a)) == jfed.tree_bytes(
        {k: jnp.asarray(v) for k, v in a.items()})
    half = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in a.items()}
    assert tfed.tree_bytes(half) == jfed.tree_bytes(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in a.items()})


def _ulps(a, b):
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ai - bi)


@pytest.mark.parametrize("lam,rho,horizon,norm", [
    (1e-3, 0.999, 50, True), (2.0, 0.9, 4, True), (30.0, 0.995, 30, True),
    (0.5, 0.97, 200, False), (0.0, 0.999, 10, True)])
def test_threshold_schedule_within_one_ulp(lam, rho, horizon, norm):
    jc = jfed.FedConfig(lam=lam, rho=rho, horizon=horizon,
                        include_horizon_norm=norm)
    tc = tfed.FedConfig(lam=lam, rho=rho, horizon=horizon,
                        include_horizon_norm=norm)
    steps = np.arange(horizon + 5)
    want = np.asarray(jax.vmap(jc.threshold)(jnp.asarray(steps, jnp.int32)))
    got = np.array([float(tc.threshold(torch.tensor(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    host = np.array([float(tc.threshold(int(s))) for s in steps], np.float32)
    np.testing.assert_array_equal(got, host)
    assert _ulps(got, want).max() <= 1, (got, want)
    assert got[-1] == got[horizon - 1]           # past N keeps the last value


# ---------------------------------------------------------------------------
# local_gain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("estimator", ["hvp", "gnorm"])
@pytest.mark.parametrize("eps", [0.3, 1.0])
def test_local_gain_mlp(estimator, eps):
    p = _mlp_params()
    X, y = _mlp_data(0)
    jl, tl = _jloss(X, y), _tloss(X, y)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    g = jax.grad(jl)(jp)
    jc = jfed.FedConfig(eps=eps, estimator=estimator)
    want = float(jfed.local_gain(g, jc, grad_fn=jax.grad(jl), params=jp))
    tp = _tparams(p)
    tg = {k: torch.from_numpy(np.array(v)) for k, v in g.items()}
    tc = tfed.FedConfig(eps=eps, estimator=estimator)
    got = tfed.local_gain(tg, tc, grad_fn=tfed.make_grad_fn(tl), params=tp)
    _, hg = jax.jvp(jax.grad(jl), (jp,), (g,))
    scale, _ = _scale(g, hg, eps)
    assert abs(float(got) - want) <= GAIN_TOL * scale, (float(got), want)
    # tree_gain is the same entry point
    again = tgd.tree_gain(tg, tc, grad_fn=tfed.make_grad_fn(tl), params=tp)
    assert float(again) == float(got)


def test_local_gain_hvp_needs_grad_fn():
    with pytest.raises(ValueError, match="grad_fn"):
        tfed.local_gain(_tparams(_mlp_params()), tfed.FedConfig())
    with pytest.raises(ValueError, match="estimator"):
        tfed.local_gain(_tparams(_mlp_params()),
                        tfed.FedConfig(estimator="adam"))


@pytest.fixture(scope="module")
def mamba_pair():
    """Reduced mamba2-370m with the reference's parameters in both
    packages, one agent's batch of 2 x 32 synthetic tokens."""
    jc = jget_config("mamba2-370m").reduced()
    jm = jbuild_model(jc)
    params = jm.init(jax.random.key(0))
    batch = make_lm_batch(SyntheticLMConfig(jc.vocab_size, 32, 2),
                          jax.random.key(1), 0)
    model = model_from_jax(get_config("mamba2-370m").reduced(),
                           jax.tree.map(np.asarray, params), device="cpu")
    model.requires_grad_(True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jm, params, batch, model, tbatch


@pytest.mark.parametrize("estimator", ["hvp", "gnorm"])
def test_local_gain_reduced_mamba2(mamba_pair, estimator):
    jm, params, batch, model, tbatch = mamba_pair
    eps = 1.0
    jl = lambda p: jm.loss_fn(p, batch)[0]                      # noqa: E731
    g, _ = jclip(jax.grad(jl)(params), 1.0)
    _, hg = jax.jvp(jax.grad(jl), (params,), (g,))
    scale, want64 = _scale(*_flat(g, hg), eps)
    if estimator == "gnorm":
        gg = sum(float(np.vdot(np.asarray(x, np.float64),
                               np.asarray(x, np.float64)))
                 for x in jax.tree.leaves(g))
        scale, want64 = eps * gg, -eps * gg
    tp = dict(model.named_parameters())
    grad_fn = tfed.make_grad_fn(lambda p: model.loss_fn(tbatch)[0])
    tg, _ = tclip({k: v.detach() for k, v in grad_fn(tp).items()}, 1.0)
    tc = tfed.FedConfig(eps=eps, estimator=estimator)
    got = float(tfed.local_gain(tg, tc, grad_fn=grad_fn, params=tp))
    assert abs(got - want64) <= GAIN_TOL * scale, (got, want64, scale)
    ref = float(jfed.local_gain(
        g, jfed.FedConfig(eps=eps, estimator=estimator),
        grad_fn=jax.grad(jl), params=params))
    assert abs(ref - want64) <= REF_VDOT_TOL * scale, (ref, want64)
    # the port's gradient is the reference's, leaf by leaf
    got_g = state_dict_to_jax(tg)
    for a, b in zip(jax.tree.leaves(got_g), jax.tree.leaves(g)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max(), rtol=0)


def _flat(a, b):
    """Two trees of the same structure as dicts of numbered leaves."""
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return dict(enumerate(la)), dict(enumerate(lb))


def test_hvp_subsample_gain_is_faithful():
    """tests/test_perf_variants.py::test_hvp_subsample_gain_is_faithful on
    the port: the quarter-batch curvature estimate stays within sampling
    noise of the full-batch gain, and both match the reference's."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, 16)).astype(np.float32)
    y = rng.normal(size=(256,)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)

    def jloss_of(bx, by):
        return lambda p: jnp.mean((bx @ p["w"] - by) ** 2)

    def tloss_of(bx, by):
        bx, by = torch.from_numpy(bx), torch.from_numpy(by)
        return lambda p: torch.mean((bx @ p["w"] - by) ** 2)

    jp = {"w": jnp.asarray(w)}
    tp = {"w": torch.from_numpy(w.copy()).requires_grad_(True)}
    g = jax.grad(jloss_of(X, y))(jp)
    tg = {"w": torch.from_numpy(np.array(g["w"]))}
    jc = jfed.FedConfig(eps=0.3, lam=1e-3, estimator="hvp")
    tc = tfed.FedConfig(eps=0.3, lam=1e-3, estimator="hvp")
    gains = {}
    for name, sl in (("full", slice(None)), ("quarter", slice(0, 64))):
        want = float(jfed.local_gain(g, jc, grad_fn=jax.grad(jloss_of(X[sl], y[sl])),
                                     params=jp))
        got = float(tfed.local_gain(
            tg, tc, grad_fn=tfed.make_grad_fn(tloss_of(X[sl], y[sl])),
            params=tp))
        _, hg = jax.jvp(jax.grad(jloss_of(X[sl], y[sl])), (jp,), (g,))
        scale, _ = _scale(g, hg, 0.3)
        assert abs(got - want) <= GAIN_TOL * scale, (name, got, want)
        gains[name] = got
    assert np.sign(gains["full"]) == np.sign(gains["quarter"])
    assert abs(gains["full"] - gains["quarter"]) < 0.35 * abs(gains["full"])


# ---------------------------------------------------------------------------
# the masked mean over 4 agents
# ---------------------------------------------------------------------------

def _agents_data():
    data = [_mlp_data(i) for i in range(AGENTS)]
    return (np.stack([d[0] for d in data]), np.stack([d[1] for d in data]))


@pytest.mark.parametrize("agg_dtype", ["float32", "bfloat16"])
def test_gated_psum_mean_four_agents(agg_dtype):
    gs = [_mlp_params(10 + i) for i in range(AGENTS)]
    for alphas in ([1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1]):
        a = np.asarray(alphas, np.float32)
        stacked = {k: jnp.asarray(np.stack([g[k] for g in gs])) for k in gs[0]}

        def ref(g, alpha):
            if agg_dtype == "bfloat16":
                g = jax.tree.map(lambda x: x.astype(jnp.bfloat16), g)
            agg, n = jfed.gated_psum_mean(g, alpha, "data")
            return jax.tree.map(lambda x: x.astype(jnp.float32), agg), n
        want, want_n = jax.vmap(ref, axis_name="data")(stacked, jnp.asarray(a))
        got, got_n = tfed.gated_psum_mean(
            [{k: torch.from_numpy(v) for k, v in g.items()} for g in gs],
            torch.from_numpy(a), agg_dtype)
        assert float(got_n) == float(want_n[0]) == a.sum()
        for k in gs[0]:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k][0]),
                                       rtol=1e-6, atol=1e-7)
            if a.sum() == 0:
                assert not got[k].any()


def _ref_gate(estimator, lam, agg_dtype, steps):
    """The reference's gate_and_aggregate for 4 agents under jax.vmap."""
    p = {k: jnp.asarray(v) for k, v in _mlp_params().items()}
    Xs, ys = _agents_data()
    cfg = jfed.FedConfig(eps=0.1, lam=lam, rho=0.9, horizon=6,
                         estimator=estimator, agg_dtype=agg_dtype)
    stats = jfed.FedStats(steps=jnp.int32(steps), tx=jnp.float32(1.5),
                          last_alpha=jnp.ones((1,)), last_gain=jnp.zeros((1,)))

    def agent(X, y):
        lf = _jloss(X, y)
        g = jax.grad(lf)(p)
        return jfed.gate_and_aggregate(g, stats, cfg, grad_fn=jax.grad(lf),
                                       params=p)
    return jax.vmap(agent, axis_name="data")(jnp.asarray(Xs), jnp.asarray(ys))


@pytest.mark.parametrize("estimator,lam,agg_dtype", [   # lam: 2 of 4 send
    ("hvp", 10.3, "float32"), ("hvp", 10.3, "bfloat16"),
    ("gnorm", 16.0, "float32"), ("hvp", 1e9, "float32")])
def test_gate_and_aggregate_four_agents(estimator, lam, agg_dtype):
    steps = 2
    want_agg, want_st = _ref_gate(estimator, lam, agg_dtype, steps)
    tp = _tparams(_mlp_params())
    Xs, ys = _agents_data()
    tc = tfed.FedConfig(eps=0.1, lam=lam, rho=0.9, horizon=6,
                        estimator=estimator, agg_dtype=agg_dtype)
    stats = tfed.FedStats(steps=torch.tensor(steps, dtype=torch.int32),
                          tx=torch.tensor(1.5), last_alpha=torch.ones(AGENTS),
                          last_gain=torch.zeros(AGENTS))

    def agents():
        for i in range(AGENTS):
            gf = tfed.make_grad_fn(_tloss(Xs[i], ys[i]))
            yield {k: v.detach() for k, v in gf(tp).items()}, gf
    agg, st = tfed.gate_and_aggregate(agents(), stats, tc, params=tp)

    want_alpha = np.asarray(want_st.last_alpha)[:, 0]
    want_gain = np.asarray(want_st.last_gain)[:, 0]
    np.testing.assert_array_equal(st.last_alpha.numpy(), want_alpha)
    thr = float(tc.threshold(steps))
    margin = np.abs(want_gain + thr).min()
    assert margin > 1e-4, f"a gain sits {margin} from the threshold: a tie"
    scale = np.abs(want_gain).max()
    np.testing.assert_allclose(st.last_gain.numpy(), want_gain,
                               atol=GAIN_TOL * scale, rtol=0)
    assert int(st.steps) == steps + 1
    np.testing.assert_allclose(float(st.tx), float(want_st.tx[0]), rtol=1e-7)
    for k in agg:
        np.testing.assert_allclose(agg[k].numpy(), np.asarray(want_agg[k][0]),
                                   rtol=1e-6, atol=1e-7)
    if lam == 1e9:
        assert not st.last_alpha.any()
        assert all(not v.any() for v in agg.values())
    else:
        assert 0 < want_alpha.sum() < AGENTS, want_gain   # a mix of decisions


def test_fed_stats_init_and_comm_rate():
    st = tfed.FedStats.init(3)
    assert st.steps.dtype == torch.int32 and st.tx.dtype == torch.float32
    assert tuple(st.last_alpha.shape) == (3,) and bool((st.last_alpha == 1).all())
    assert float(st.comm_rate()) == 0.0
    st = st._replace(steps=torch.tensor(4, dtype=torch.int32), tx=torch.tensor(3.0))
    assert float(st.comm_rate()) == 0.75
    assert dataclasses.asdict(tfed.FedConfig()) == dataclasses.asdict(jfed.FedConfig())
