"""repro_torch.optim against repro.optim on shared numpy trees.

sgd (with and without momentum), adamw with weight decay over three steps
(updates, moments and step count), clip_by_global_norm, cosine_schedule
at warmup, middle and end, and apply_updates on bf16 parameters.  Trees
are dicts of float32 leaves, the port's keyed as the reference's; results
agree within 1e-6 relative (float32 arithmetic in another order: XLA may
fuse a multiply-add where torch rounds twice, and its ``pow`` and ``cos``
are not torch's in the last ulp).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.optim import optimizers as jopt  # noqa: E402

from repro_torch.optim import optimizers as topt  # noqa: E402

RTOL = 1e-6
SHAPES = {"w": (7, 5), "b": (5,), "emb": (11, 3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool spinning beside them costs more than it gains at these
    sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, rtol=RTOL):
    for k in want:
        w = np.asarray(want[k], np.float32)
        g = np.asarray(got[k].float() if torch.is_tensor(got[k]) else got[k],
                       np.float32)
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rtol * max(np.abs(w).max(), 1e-30))


def _run(jo, to, steps=3):
    """``steps`` updates of both optimizers on the same gradients; returns
    (reference updates and state, port updates and state) of each step."""
    params = _tree(0)
    js, ts = jo.init(_j(params)), to.init(_t(params))
    out = []
    for s in range(steps):
        grads = _tree(10 + s, scale=0.1)
        ju, js = jo.update(_j(grads), js, _j(params))
        tu, ts = to.update(_t(grads), ts, _t(params))
        out.append((ju, js, tu, ts))
        params = {k: np.asarray(v) + np.asarray(ju[k]) for k, v in params.items()}
    return out


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_reference(momentum):
    for ju, js, tu, ts in _run(jopt.sgd(0.05, momentum=momentum),
                               topt.sgd(0.05, momentum=momentum)):
        _close(tu, ju)
        assert int(ts.step) == int(js.step)
        assert ts.step.dtype == torch.int32
        if momentum:
            _close(ts.mu, js.mu)
        else:
            assert ts.mu is None and js.mu is None


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_with_weight_decay_three_steps(schedule):
    lr_j = jopt.cosine_schedule(1e-2, 1, 3) if schedule else 1e-2
    lr_t = topt.cosine_schedule(1e-2, 1, 3) if schedule else 1e-2
    for ju, js, tu, ts in _run(jopt.adamw(lr_j, weight_decay=0.1),
                               topt.adamw(lr_t, weight_decay=0.1)):
        _close(tu, ju)
        _close(ts.mu, js.mu)
        _close(ts.nu, js.nu)
        assert int(ts.step) == int(js.step)
        assert all(m.dtype == torch.float32 for m in ts.mu.values())


def test_adamw_moments_are_float32_for_bf16_params():
    params = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in _tree(0).items()}
    st = topt.adamw(1e-3).init(params)
    assert all(m.dtype == torch.float32 for m in st.mu.values())
    assert all(v.dtype == torch.float32 for v in st.nu.values())


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm(max_norm):
    grads = _tree(3)
    jc, jn = jopt.clip_by_global_norm(_j(grads), max_norm)
    tc, tn = topt.clip_by_global_norm(_t(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    _close(tc, jc)


def test_clip_scale_takes_the_gradient_dtype():
    grads = {k: jnp.asarray(v, jnp.bfloat16) for k, v in _tree(4).items()}
    jc, jn = jopt.clip_by_global_norm(grads, 0.5)
    tc, tn = topt.clip_by_global_norm(
        {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
         for k, v in grads.items()}, 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    for k in grads:
        assert tc[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tc[k].float().numpy(),
                                      np.asarray(jc[k], np.float32))


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_cosine_schedule_warmup_middle_end(step):
    j = jopt.cosine_schedule(3e-4, 10, 100)(jnp.int32(step))
    t = topt.cosine_schedule(3e-4, 10, 100)(torch.tensor(step, dtype=torch.int32))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def test_apply_updates_on_bf16_params():
    params = _tree(5)
    upd = _tree(6, scale=1e-2)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in jp.items()}
    jn = jopt.apply_updates(jp, _j(upd))
    tn = topt.apply_updates(tp, _t(upd))
    for k in params:
        assert tn[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(tn[k].float().numpy(),
                                      np.asarray(jn[k], np.float32))
