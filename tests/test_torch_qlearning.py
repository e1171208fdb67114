"""repro_torch.core.qlearning (paper Remark 1) against repro.core.qlearning.

The exact quantities equal the reference's; ``make_q_sampler`` draws the
reference's streams (phi exactly, targets at 1e-6 relative), batched over
runs and agents; the gated Q-iteration of tests/test_qlearning.py:53 runs
on the port through ``run_value_iteration`` and matches the reference's
run (weights 1e-5, decisions exact with ties reported), then holds the
reference test's error bound against the exact Q.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import algorithm1 as ja1  # noqa: E402
from repro.core import qlearning as jq  # noqa: E402
from repro.core.trigger import TriggerConfig as JTrig  # noqa: E402
from repro.envs import GridWorld as JGrid  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch import random as trandom  # noqa: E402
from repro_torch.core import algorithm1 as ta1  # noqa: E402
from repro_torch.core import qlearning as tq  # noqa: E402
from repro_torch.core.trigger import TriggerConfig as TTrig  # noqa: E402
from repro_torch.envs import GridWorld as TGrid  # noqa: E402

from test_torch_algorithm1 import (decision_ties,  # noqa: E402
                                   one_thread)  # noqa: F401  (fixture)

TOL, TARGET_RTOL = 1e-5, 1e-6
# long loops of tiny ops run on one intra-op thread (one_thread)
pytestmark = pytest.mark.usefixtures("one_thread")
JGW, TGW = JGrid(gamma=0.9), TGrid(gamma=0.9)


def test_exact_q_is_fixed_point():
    q = tq.exact_q(TGW)
    np.testing.assert_array_equal(q, jq.exact_q(JGW))
    np.testing.assert_allclose(tq.bellman_q_update(TGW, q), q, atol=1e-9)
    assert tq.q_dimension(TGW) == jq.q_dimension(JGW) == 100
    q_cur = np.linspace(0, 1, 100)
    np.testing.assert_array_equal(tq.bellman_q_update(TGW, q_cur),
                                  jq.bellman_q_update(JGW, q_cur))
    tp, jp = tq.q_problem(TGW, q_cur), jq.q_problem(JGW, q_cur)
    for name in ("phi_matrix", "d_weights", "targets"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)


def test_q_sampler_draws_the_reference_streams():
    """Batched over (runs, agents) = (2, 3): phi exactly, targets 1e-6."""
    q_cur = np.linspace(0, 1, 100).astype(np.float32)
    jkeys = jax.random.split(jax.random.key(2), 6).reshape(2, 3)
    jphi, jy = jax.vmap(jax.vmap(jq.make_q_sampler(JGW, jnp.asarray(q_cur),
                                                   50)))(jkeys)
    tphi, ty = tq.make_q_sampler(TGW, q_cur, 50)(
        convert.key_to_torch(jax.random.key_data(jkeys), device="cpu"))
    np.testing.assert_array_equal(tphi.numpy(), np.asarray(jphi))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TARGET_RTOL,
                               atol=TARGET_RTOL)


def test_q_sampler_unbiased():
    q_cur = np.linspace(0, 1, tq.q_dimension(TGW))
    phi_t, targets = tq.make_q_sampler(TGW, q_cur, 40_000)(trandom.key(0))
    idx = phi_t.argmax(dim=1).numpy()
    exact = tq.bellman_q_update(TGW, q_cur)
    for sa in range(0, tq.q_dimension(TGW), 17):
        sel = idx == sa
        if sel.sum() > 200:
            np.testing.assert_allclose(targets.numpy()[sel].mean(),
                                       exact[sa], atol=6e-2)


def test_gated_q_iteration_converges():
    """Full Algorithm 1 on Q (tests/test_qlearning.py:53): outer
    expected-SARSA updates, gated inner fits; the port's run against the
    reference's, then the reference test's bounds."""
    n = tq.q_dimension(TGW)
    eps = 12.0
    rho = min(jq.q_problem(JGW, np.zeros(n)).min_rho(eps) * 1.0001, 0.9999)
    kw = dict(eps=eps, num_agents=2, mode="practical")
    outer = 4
    jw, jtraces = ja1.run_value_iteration(
        jax.random.key(0), jnp.zeros(n),
        lambda qw: jq.make_q_sampler(JGW, qw, 60),
        ja1.GatedSGDConfig(trigger=JTrig(1e-4, rho, 200), **kw), outer)
    tw, ttraces = ta1.run_value_iteration(
        trandom.key(0), torch.zeros(n),
        lambda qw: tq.make_q_sampler(TGW, qw, 60),
        ta1.GatedSGDConfig(trigger=TTrig(1e-4, rho, 200), **kw,
                           step_backend="megastep", gain_backend="kernel"),
        outer, device="cpu")
    thr = np.asarray(JTrig(1e-4, rho, 200).schedule())[None]
    for i, (jt, tt) in enumerate(zip(jtraces, ttraces)):
        assert not decision_ties(tt.alphas[None].numpy(),
                                 np.asarray(jt.alphas)[None],
                                 np.asarray(jt.gains)[None], thr), i
        np.testing.assert_allclose(tt.weights.numpy(),
                                   np.asarray(jt.weights), rtol=TOL,
                                   atol=TOL, err_msg=f"outer step {i}")
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL, atol=TOL)
    rates = [float(t.comm_rate) for t in ttraces]
    assert all(0.0 <= r <= 1.0 for r in rates)
    assert any(r < 1.0 for r in rates)


def test_gated_q_iteration_error_bound():
    """The reference test's own setting, 40 outer steps, on the port: the
    error bound against the exact Q_pi."""
    n = tq.q_dimension(TGW)
    eps = 12.0
    rho = min(tq.q_problem(TGW, np.zeros(n)).min_rho(eps) * 1.0001, 0.9999)
    cfg = ta1.GatedSGDConfig(trigger=TTrig(1e-4, rho, 200), eps=eps,
                             num_agents=2, mode="practical")
    w, traces = ta1.run_value_iteration(
        trandom.key(0), torch.zeros(n),
        lambda qw: tq.make_q_sampler(TGW, qw, 60), cfg, num_outer=40,
        device="cpu")
    q_true = tq.exact_q(TGW)
    err = float(np.max(np.abs(w.numpy() - q_true)))
    assert err < 0.2 * float(np.max(np.abs(q_true))), err
    assert any(float(t.comm_rate) < 1.0 for t in traces)
