"""The port's MoE MLP (``repro_torch.models.moe``) against repro.models.moe.

Every case of tests/test_moe.py on the port, plus the port against the
reference's ``apply_moe`` itself on shared numpy inputs and parameters
(``init_moe`` drawn by JAX, carried over as numpy): outputs at 1e-5 with
ample capacity (k 1, 2 and 4), with a tiny capacity that drops tokens,
and the Switch balance loss and z-loss.  Also what the module promises
beyond the reference: the top-k order on ties, a routing replay that
reproduces the free routing, and a dispatch that repeats bit for bit.
"""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import moe as jmoe  # noqa: E402

from repro_torch.models import moe  # noqa: E402

TOL = 1e-5


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


def _params(seed, d, ff, E, activation="swiglu"):
    """(reference params, port params): the reference's init_moe draw."""
    jp = jmoe.init_moe(jax.random.key(seed), d, ff, E, activation, jnp.float32)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _both(jp, tp, x, *args):
    """The reference's and the port's apply_moe on the same x (numpy)."""
    want = jmoe.apply_moe(jp, jnp.asarray(x), *args)
    got = moe.apply_moe(tp, torch.from_numpy(x), *args)
    return got, want


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


# -- the port against the reference's apply_moe -------------------------------

@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu2"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_apply_moe_matches_reference_with_ample_capacity(rng, k, activation):
    jp, tp = _params(0, 16, 32, 8, activation)
    x = (rng.normal(size=(2, 24, 16)) * 0.5).astype(np.float32)
    (out, aux), (jout, jaux) = _both(jp, tp, x, k, 8.0, activation, 0.01, 1e-3)
    assert out.shape == (2, 24, 16) and out.dtype == torch.float32
    _close(out, jout)
    _close(aux, jaux)


def test_apply_moe_matches_reference_when_tokens_drop(rng):
    """Capacity 8 for 64 tokens x 2 choices over 4 experts: most choices
    drop, and which ones is the position cumsum's order."""
    jp, tp = _params(1, 8, 16, 4)
    x = rng.normal(size=(2, 64, 8)).astype(np.float32)
    assert moe.capacity(64, 4, 2, 0.1) == 8
    (out, aux), (jout, jaux) = _both(jp, tp, x, 2, 0.1, "swiglu", 0.01, 1e-3)
    _close(out, jout)
    _close(aux, jaux)
    r = moe.route(torch.from_numpy(x), tp["router"], 2, 8)
    assert int((r.gates_flat == 0).sum()) > 64      # most choices dropped
    assert int(r.safe_pos.max()) == 8               # the scratch slot


@pytest.mark.parametrize("aux_coef,z_coef", [(1.0, 0.0), (0.0, 1.0), (0.01, 1e-3)])
def test_aux_and_z_losses_match_reference(rng, aux_coef, z_coef):
    jp, tp = _params(2, 16, 32, 8)
    x = rng.normal(size=(3, 20, 16)).astype(np.float32)
    (_, aux), (_, jaux) = _both(jp, tp, x, 2, 1.25, "swiglu", aux_coef, z_coef)
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(aux, jaux)


def test_routing_matches_reference_row_by_row(rng):
    """``route`` against the reference's per-row routing: the same experts
    in the same order, the same slots and gates."""
    jp, tp = _params(3, 16, 32, 8)
    x = rng.normal(size=(2, 40, 16)).astype(np.float32)
    C = moe.capacity(40, 8, 2, 1.25)
    r = moe.route(torch.from_numpy(x), tp["router"], 2, C)
    for b in range(2):
        logits, probs, ids, flat, pos, gates = jmoe._route_one_row(
            jnp.asarray(x[b]), jp["router"], 2, C)
        np.testing.assert_array_equal(r.expert_ids[b].numpy(), np.asarray(ids))
        np.testing.assert_array_equal(r.safe_pos[b].numpy(), np.asarray(pos))
        _close(r.gates_flat[b], gates)
        _close(r.probs[b], probs)


# -- tests/test_moe.py on the port --------------------------------------------

def _dense_reference(params, x, k, activation):
    """Loop-over-experts reference with unlimited capacity (plain torch)."""
    B, L, d = x.shape
    E = params["router"].shape[-1]
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    gates, ids = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(xt)
    for e in range(E):
        up = xt @ params["w_up"][e]
        if activation == "swiglu":
            up = torch.nn.functional.silu(xt @ params["w_gate"][e]) * up
        else:
            up = torch.nn.functional.gelu(up, approximate="tanh")
        y = up @ params["w_down"][e]
        w_e = torch.where(ids == e, gates, torch.zeros(())).sum(-1)
        out = out + w_e[:, None] * y
    return out.reshape(B, L, d)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_moe_matches_dense_reference_with_ample_capacity(rng, k):
    B, L, d, ff, E = 2, 16, 8, 16, 8
    _, params = _params(0, d, ff, E)
    x = torch.from_numpy((rng.normal(size=(B, L, d)) * 0.5).astype(np.float32))
    out, aux = moe.apply_moe(params, x, k, capacity_factor=8.0,
                             activation="swiglu", aux_coef=0.0, z_coef=0.0)
    torch.testing.assert_close(out, _dense_reference(params, x, k, "swiglu"),
                               rtol=2e-4, atol=2e-4)
    assert float(aux) == 0.0


def test_moe_tiny_capacity_drops_but_stays_finite(rng):
    B, L, d, ff, E = 1, 64, 8, 16, 4
    _, params = _params(1, d, ff, E)
    x = torch.from_numpy(rng.normal(size=(B, L, d)).astype(np.float32))
    out, aux = moe.apply_moe(params, x, 2, capacity_factor=0.1,
                             activation="swiglu", aux_coef=0.01, z_coef=1e-3)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux))
    # dropped tokens must contribute exactly zero, not garbage
    full, _ = moe.apply_moe(params, x, 2, capacity_factor=8.0,
                            activation="swiglu", aux_coef=0.0, z_coef=0.0)
    assert float(out.abs().mean()) <= float(full.abs().mean()) + 1e-3
    r = moe.route(x, params["router"], 2, moe.capacity(L, E, 2, 0.1))
    dropped = (r.gates_flat[0] == 0).reshape(L, 2).all(-1)
    assert bool(dropped.any())
    assert float(out[0, dropped].abs().max()) == 0.0


def test_aux_loss_penalizes_imbalance(rng):
    """tests/test_moe.py's derivation: balanced routing gives aux ~ 1, a
    router collapsed onto one expert (a +50 column on positive inputs)
    gives aux ~ E."""
    B, L, d, ff, E = 1, 32, 8, 16, 4
    _, params = _params(2, d, ff, E)
    x = torch.from_numpy(np.abs(rng.normal(size=(B, L, d))).astype(np.float32))
    _, aux_balanced = moe.apply_moe(params, x, 1, 4.0, "swiglu", 1.0, 0.0)
    skew = params["router"].clone()
    skew[:, 0] += 50.0
    _, aux_skew = moe.apply_moe(dict(params, router=skew), x, 1, 4.0,
                                "swiglu", 1.0, 0.0)
    assert float(aux_skew) > float(aux_balanced)
    assert float(aux_skew) > 0.75 * E, float(aux_skew)


def test_capacity_rounding():
    assert moe.capacity(100, 4, 2, 1.25) % 8 == 0
    assert moe.capacity(100, 4, 2, 1.25) >= 100 * 2 * 1.25 / 4
    for args in [(100, 4, 2, 1.25), (1, 64, 8, 1.25), (8192, 64, 8, 1.25),
                 (1024, 16, 2, 8.0), (37, 8, 3, 0.5)]:
        assert moe.capacity(*args) == jmoe.capacity(*args)
    assert moe.capacity(1, 64, 8, 1.25) == 8     # decode: one token a row


# -- what the port adds ---------------------------------------------------------

def test_top_k_takes_the_lower_expert_on_a_tie():
    """``jax.lax.top_k``'s order, which the position cumsum reads."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.4, 0.1, 0.4, 0.1]])
    np.testing.assert_array_equal(moe.top_k_ids(probs, 2).numpy(),
                                  [[1, 2], [0, 2]])
    np.testing.assert_array_equal(
        moe.top_k_ids(probs, 2).numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 2)[1]))


def test_replayed_routing_reproduces_the_free_routing(rng, monkeypatch):
    """``route`` with ``top_k_ids`` swapped for the free routing's own
    choices gives the same slots and gates: what a record-and-replay check
    relies on."""
    _, params = _params(4, 16, 32, 8)
    x = torch.from_numpy(rng.normal(size=(2, 30, 16)).astype(np.float32))
    C = moe.capacity(30, 8, 2, 1.25)
    free = moe.route(x, params["router"], 2, C)
    monkeypatch.setattr(moe, "top_k_ids", lambda probs, k: free.expert_ids)
    again = moe.route(x, params["router"], 2, C)
    for a, b in zip(free, again):
        assert torch.equal(a, b)


def test_dispatch_and_combine_repeat_bitwise(rng):
    """Every kept slot is written by one token, so two calls agree bit for
    bit, and each kept slot holds its token's row exactly."""
    _, params = _params(5, 16, 32, 8)
    x = torch.from_numpy(rng.normal(size=(2, 50, 16)).astype(np.float32))
    a = moe.apply_moe(params, x, 2, 0.5, "swiglu", 0.01, 1e-3)
    b = moe.apply_moe(params, x, 2, 0.5, "swiglu", 0.01, 1e-3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    C = moe.capacity(50, 8, 2, 0.5)
    r = moe.route(x, params["router"], 2, C)
    slots = moe.dispatch(x, r, 8, C).reshape(8, 2, C, 16)
    for bi in range(2):
        for j in range(100):
            e, p = int(r.flat_ids[bi, j]), int(r.safe_pos[bi, j])
            if p < C:
                assert torch.equal(slots[e, bi, p], x[bi, j // 2])


def _chip_smoke():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_smoke_routing_replay_reports_flips(rng, monkeypatch):
    """chip_smoke.Routing, as the card's kernel-vs-plain checks use it: a
    second forward replays the first one's experts, and a token whose own
    top-k differs is reported with the first forward's margin; the report
    fails only when that margin is wider than a tie."""
    smoke = _chip_smoke()
    _, params = _params(6, 16, 32, 8)
    x = torch.from_numpy(rng.normal(size=(1, 12, 16)).astype(np.float32))
    top_k_ids = moe.top_k_ids
    routing = smoke.Routing()
    with routing.record():
        first = moe.apply_moe(params, x, 2, 1.25, "swiglu", 0.0, 0.0)[0]
    # move token 5 to the expert just outside its top 2
    r = moe.route(x, params["router"], 2, 8)
    third = int(moe.top_k_ids(r.probs[0, 5], 3)[2])
    nudged = dict(params, router=params["router"].clone())
    nudged["router"][:, third] += 4.0 * x[0, 5] / x[0, 5].norm() ** 2
    with routing.replay():
        replayed = moe.apply_moe(nudged, x, 2, 1.25, "swiglu", 0.0, 0.0)[0]
    free = moe.route(x, nudged["router"], 2, 8).expert_ids
    assert not torch.equal(free, routing.ids[0])      # the free routing moved
    assert len(routing.ids) == 1 and len(routing.flips) >= 1
    assert all(call == 0 for call, _ in routing.flips)
    # the replay ran on the recorded experts, not on the free ones
    with monkeypatch.context() as m:
        m.setattr(moe, "top_k_ids", lambda probs, k: routing.ids[0])
        r = moe.route(x, nudged["router"], 2, 8)
    expert_out = moe.expert_ffn(nudged, moe.dispatch(x, r, 8, 8), "swiglu")
    want = moe.combine(expert_out, r, 1, 8)
    assert torch.equal(replayed, want) and first.shape == replayed.shape
    assert moe.top_k_ids is top_k_ids           # the contexts restore it
    with pytest.raises(smoke.SmokeFailure, match="tie margin"):
        routing.report("nudged router")
    # each replay counts its own flips: the recorded router flips nothing
    with routing.replay():
        again = moe.apply_moe(params, x, 2, 1.25, "swiglu", 0.0, 0.0)[0]
    assert routing.flips == [] and torch.equal(again, first)
    tie = smoke.Routing()
    tie.flips = [(0, smoke.ROUTING_TIE_MARGIN / 2)]
    assert tie.report("tie")["flips"] == 1
