"""repro_torch.envs against repro.envs.

Garnet and gridworld transition tensors and costs are bitwise equal (the
numpy construction is copied); fleets and stacked families equal; exact
problem terms at 1e-6; samplers at fixed keys draw the same states,
actions and successors, and targets within a few ulp (``normal`` goes
through torch's ``log1p``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.envs import base as jbase  # noqa: E402
from repro.envs import garnet as jgarnet  # noqa: E402
from repro.envs.gridworld import GridWorld as JGrid  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.envs import base as tbase  # noqa: E402
from repro_torch.envs import garnet as tgarnet  # noqa: E402
from repro_torch.envs.gridworld import GridWorld as TGrid  # noqa: E402


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _keys(R, m, seed=7):
    jk = jax.random.split(jax.random.key(seed), R * m).reshape(R, m)
    return jk, convert.key_to_torch(jax.random.key_data(jk), device="cpu")


@pytest.mark.parametrize("kw", [dict(num_states=12), dict(
    num_states=30, num_actions=3, branching=5, seed=4, gamma=0.9)])
def test_garnet_tables_bitwise(kw):
    j, t = jgarnet.GarnetMDP(**kw), tgarnet.GarnetMDP(**kw)
    _eq(t.transition_matrix(), j.transition_matrix())
    _eq(t.cost_vector(), j.cost_vector())
    jp, tp = j.env_params(), t.env_params()
    for k in ("P", "c"):
        _eq(tp[k].numpy(), jp[k])
    _eq(t.exact_value(), j.exact_value())
    v = np.linspace(0, 1, kw["num_states"]).astype(np.float32)
    tv, jv = t.vfa_problem(v), j.vfa_problem(v)
    _eq(tv.targets.numpy(), jv.targets)
    assert tv.max_stable_stepsize() == pytest.approx(jv.max_stable_stepsize())


def test_gridworld_tables_bitwise():
    j, t = JGrid(), TGrid()
    _eq(t.transition_matrix(), j.transition_matrix())
    _eq(t.cost_vector(), j.cost_vector())
    _eq(t.exact_value(), j.exact_value())


def test_fleets_and_family_terms():
    S, E = 12, 3
    w0 = np.linspace(-1, 1, S).astype(np.float32)
    jenvs, jfam = jgarnet.garnet_env_family(E, v_current=w0, num_states=S)
    tenvs, tfam = tgarnet.garnet_env_family(E, v_current=w0, num_states=S)
    for k in ("P", "c", "gamma"):
        _eq(tfam.params[k].numpy(), jfam.params[k])
    for got, want in zip(tfam.terms, jfam.terms):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    jfl = jgarnet.garnet_fleet_sets(jenvs, w0, 5, num_junk=2)
    tfl = tgarnet.garnet_fleet_sets(tenvs, w0, 5, num_junk=2)
    assert set(tfl) == set(jfl)
    for k in jfl:
        _eq(tfl[k].numpy(), jfl[k])
    one = tbase.family_problem_terms(tenvs[1].env_params(), w0)
    for got, want in zip(one, jbase.family_problem_terms(
            jenvs[1].env_params(), jnp.asarray(w0))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tgarnet.garnet_fleet_sets(tenvs, w0, 2, num_junk=3)


def test_family_sampler_matches_vmapped_reference():
    """(runs, agents) keys in one call = the reference vmapped twice."""
    S, R, m, T = 12, 2, 4, 16
    w0 = np.linspace(0, 2, S).astype(np.float32)
    jenvs, jfam = jgarnet.garnet_env_family(2, num_states=S)
    tenvs, tfam = tgarnet.garnet_env_family(2, num_states=S)
    jfl = jgarnet.garnet_fleet_sets(jenvs, w0, m, num_junk=2)
    tfl = tgarnet.garnet_fleet_sets(tenvs, w0, m, num_junk=2)
    jk, tk = _keys(R, m)
    jfn = jbase.family_sampler_fn(T)
    want_phi, want_y = jax.vmap(jax.vmap(jfn, (None, 0, 0)), (0, 0, 0))(
        jfam.params, jfl, jk)
    got_phi, got_y = tbase.family_sampler_fn(T)(tfam.params, tfl, tk)
    _eq(got_phi.numpy(), want_phi)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)
    # one env shared by all runs, through the single-instance sampler
    jfn1 = jenvs[0].sampler_fn(T)
    jp = jenvs[0].agent_params(w0, m, noise_scale=0.5)
    tp = tenvs[0].agent_params(w0, m, noise_scale=0.5)
    want_phi, want_y = jax.vmap(jax.vmap(jfn1), (None, 0))(jp, jk)
    got_phi, got_y = tenvs[0].sampler_fn(T)(
        {k: v.expand((R,) + v.shape) for k, v in tp.items()}, tk)
    _eq(got_phi.numpy(), want_phi)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)


def test_gridworld_closure_sampler_matches_reference():
    R, m, T = 2, 3, 20
    j, t = JGrid(), TGrid()
    v = np.asarray(j.exact_value(), np.float32)
    jk, tk = _keys(R, m, seed=3)
    want_phi, want_y = jax.vmap(jax.vmap(j.make_sampler(jnp.asarray(v), T)))(jk)
    got_phi, got_y = t.make_sampler(v, T)(tk)
    _eq(got_phi.numpy(), want_phi)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-6)


def test_param_sampler_and_stacks():
    env = tgarnet.GarnetMDP(num_states=6)
    ps = tbase.as_param_sampler(env, np.zeros(6), 3, 4, noise_scale=0.1)
    assert ps.num_agents == 3
    assert ps.params["visit_logits"].shape == (3, 6)
    rows = [env.agent_param_row(np.zeros(6)) for _ in range(2)]
    st = tbase.stack_agent_params(*rows)
    assert st["v"].shape == (2, 6)
    fam = tbase.stack_env_fleets([st, st])
    assert fam["noise_scale"].shape == (2, 2)
    with pytest.raises(ValueError):
        tbase.stack_env_fleets([])
    assert isinstance(env, tbase.Env)
