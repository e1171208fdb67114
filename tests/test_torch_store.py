"""repro_torch.experiments.store against repro.experiments.store.

The port's spec payload is the reference's plus ``framework: "torch"``
(``chunk_size`` left out in both), with the backend defaults
read from the port's own variables; so no port entry takes a JAX entry's
hash.  Put, get, verify, quarantine and merge round trips; a merge holds
overlapping λ cells bitwise except ``j_final``, held at 1e-6 relative.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.channel import ChannelSpec as JChan  # noqa: E402
from repro.experiments import store as jstore  # noqa: E402
from repro.experiments.sweep import SweepSpec as JSpec  # noqa: E402

from repro_torch.core.algorithm1 import TraceSpec  # noqa: E402
from repro_torch.core.channel import ChannelSpec as TChan  # noqa: E402
from repro_torch.experiments import store as tstore  # noqa: E402
from repro_torch.experiments.sweep import SweepSpec as TSpec  # noqa: E402

BASE = dict(modes=("theoretical", "practical"), lambdas=(1e-3, 1e-2),
            seeds=(0, 1), rhos=(0.95,), eps=0.4, num_iterations=20,
            num_agents=3)

PAYLOAD_CASES = {
    "plain": dict(gain_backend="reference", step_backend="reference"),
    "fused": dict(gain_backend="reference", step_backend="fused"),
    "summary": dict(gain_backend="reference", trace="summary"),
    "trace-spec": dict(gain_backend="reference",
                       trace=TraceSpec(alphas=True)),
    "channels": dict(gain_backend="reference", step_backend="fused",
                     channel_sets=((0.3, 0, 0), ((0.1, 0.2, 0.3), 2, 1))),
    "tagged": dict(gain_backend="reference", tag="mixed",
                   random_tx_prob=np.array([0.1, 0.4], np.float32)),
    "chunked": dict(gain_backend="reference", chunk_size=64),
}


def _pair(**kw):
    """The same grid as a port spec and as a reference spec (both step
    backends' defaults are explicit: they differ, see below)."""
    kw.setdefault("step_backend", "reference")
    chans = kw.pop("channel_sets", None)
    jkw = dict(kw)
    if isinstance(kw.get("trace"), TraceSpec):
        from repro.core.algorithm1 import TraceSpec as JTrace
        jkw["trace"] = JTrace(*kw["trace"])
    t = TSpec(**BASE, **kw, channel_sets=(
        None if chans is None else tuple(TChan(*c) for c in chans)))
    j = JSpec(**BASE, **jkw, channel_sets=(
        None if chans is None else tuple(JChan(*c) for c in chans)))
    return t, j


def _reference_plus_framework(tspec, jspec):
    return dict(jstore.spec_payload(jspec), framework="torch")


@pytest.mark.parametrize("case", sorted(PAYLOAD_CASES))
def test_payload_is_the_reference_plus_framework(case):
    t, j = _pair(**PAYLOAD_CASES[case])
    assert tstore.spec_payload(t) == _reference_plus_framework(t, j)
    assert tstore.spec_hash(t) == tstore.spec_hash(
        dataclasses.replace(t, chunk_size=None))
    assert tstore.spec_hash(t) != jstore.spec_hash(j)
    assert tstore.family_hash(t) != jstore.family_hash(j)
    # a payload re-hashes to itself (store entries re-derive their hash)
    assert tstore.spec_hash(tstore.spec_payload(t)) == tstore.spec_hash(t)


def test_summary_trace_hashes_as_the_default_trace_spec():
    a, _ = _pair(gain_backend="reference", trace="summary")
    b, _ = _pair(gain_backend="reference", trace=TraceSpec())
    assert tstore.spec_hash(a) == tstore.spec_hash(b)


def test_backend_defaults_read_the_ports_variables(monkeypatch):
    for var in ("REPRO_TORCH_GAIN_BACKEND", "REPRO_TORCH_STEP_BACKEND",
                "REPRO_GAIN_BACKEND", "REPRO_STEP_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    default = TSpec(**BASE)
    payload = tstore.spec_payload(default)
    assert payload["gain_backend"] == "kernel"
    assert payload["step_backend"] == "megastep"
    assert tstore.spec_hash(default) == tstore.spec_hash(
        TSpec(**BASE, gain_backend="kernel", step_backend="megastep"))
    # the reference's variables do not move a port hash ...
    monkeypatch.setenv("REPRO_GAIN_BACKEND", "pallas")
    monkeypatch.setenv("REPRO_STEP_BACKEND", "fused")
    assert tstore.spec_payload(default) == payload
    # ... the port's do, and step_backend="reference" leaves the payload
    monkeypatch.setenv("REPRO_TORCH_GAIN_BACKEND", "reference")
    monkeypatch.setenv("REPRO_TORCH_STEP_BACKEND", "reference")
    t, j = _pair(step_backend=None)
    monkeypatch.setenv("REPRO_GAIN_BACKEND", "reference")
    monkeypatch.setenv("REPRO_STEP_BACKEND", "reference")
    assert tstore.spec_payload(t) == _reference_plus_framework(t, j)
    assert "step_backend" not in tstore.spec_payload(t)


def _arrays(lams, seed=0, shape=(2, 2, 1, 2)):
    """Result arrays of a (mode, lam, rho, seed) grid; a λ column's values
    depend only on λ, so sub-grids agree cell for cell."""
    m, _, r, s = shape
    cols = [np.random.default_rng([seed, int(1e6 * l)]).normal(
        size=(m, r, s, 3)).astype(np.float32) for l in lams]
    w = np.stack(cols, axis=1)
    return {"trace/final_weights": w,
            "trace/comm_rate": w[..., 0].copy(),
            "trace/j_final": np.abs(w[..., 1]) + 1.0}


AXES = ("mode", "lam", "rho", "seed")


def _spec(lams, **kw):
    return TSpec(**dict(BASE, lambdas=tuple(lams)), gain_backend="reference",
                 trace="summary", **kw)


def test_put_get_round_trip_and_append_only(tmp_path):
    st = tstore.SweepStore(tmp_path)
    spec, arrays = _spec((1e-3, 1e-2)), _arrays((1e-3, 1e-2))
    h = st.put(spec, arrays, AXES, extra={"inputs_digest": "d"})
    assert h == tstore.spec_hash(spec) and st.has(spec) and st.hashes() == [h]
    got = st.get(h, verify=True)
    assert got.axes == AXES and got.extra == {"inputs_digest": "d"}
    assert got.lambdas == [1e-3, 1e-2] and got.modes == list(BASE["modes"])
    for k, v in arrays.items():
        assert got.arrays[k].tobytes() == v.tobytes()
    assert st.put(spec, arrays, AXES, extra={"inputs_digest": "d"}) == h
    other = dict(arrays, **{"trace/comm_rate": arrays["trace/comm_rate"] + 1})
    with pytest.raises(ValueError, match="append-only"):
        st.put(spec, other, AXES)
    meta = json.loads((tmp_path / h / "meta.json").read_text())
    assert meta["spec"]["framework"] == "torch"
    # the layout is the reference's: its store reads a port entry
    ref = jstore.SweepStore(tmp_path).get(h, verify=True)
    assert ref.spec_hash == h and sorted(ref.arrays) == sorted(arrays)


def test_verify_quarantine_and_self_heal(tmp_path):
    st = tstore.SweepStore(tmp_path)
    spec, arrays = _spec((1e-3,)), _arrays((1e-3,))
    h = st.put(spec, arrays, AXES)
    assert st.verify_all() == {h: None}
    path = tmp_path / h / "arrays.npz"
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x10
    path.write_bytes(bytes(blob))
    with pytest.raises(tstore.StoreCorruptError) as err:
        st.get(h, verify=True)
    assert err.value.spec_hash == h
    assert st.verify_all()[h] is not None
    # put over a committed-but-corrupt entry quarantines it, writes afresh
    assert st.put(spec, arrays, AXES) == h
    assert st.verify_all() == {h: None}
    assert sorted(os.listdir(tmp_path)) == [h, f"{h}.quarantined-0"]
    moved = st.quarantine(h, "test")
    assert moved.endswith(f"{h}.quarantined-1") and st.hashes() == []
    # a meta.json whose spec no longer hashes to its directory is corrupt
    h2 = st.put(spec, arrays, AXES)
    meta_path = tmp_path / h2 / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["spec"]["eps"] = 0.5
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(tstore.StoreCorruptError, match="re-hashes"):
        st.get(h2, verify=True)


def test_merge_disjoint_and_overlapping_lambdas(tmp_path):
    st = tstore.SweepStore(tmp_path)
    for lams in ((1e-3, 1e-2), (1e-2, 1e-1), (1e-4,)):
        st.put(_spec(lams), _arrays(lams), AXES, extra={"inputs_digest": "d"})
    full = (1e-4, 1e-3, 1e-2, 1e-1)
    assert st.covered_lambdas(_spec(full), inputs_digest="d") == list(full)
    assert st.missing_lambdas(_spec(full + (1.0,)), inputs_digest="d") == (1.0,)
    assert st.missing_lambdas(_spec(full), inputs_digest="other") == full
    merged = st.merged(_spec(full), inputs_digest="d", put=True)
    assert merged.lambdas == list(full)
    assert merged.spec_hash == tstore.spec_hash(_spec(full))
    want = _arrays(full)
    for k, v in want.items():
        assert merged.arrays[k].tobytes() == v.tobytes()
    assert st.get(_spec(full)).arrays.keys() == want.keys()


@pytest.mark.parametrize("key,delta,ok", [
    ("trace/j_final", 5e-7, True),        # within 1e-6 relative
    ("trace/j_final", 5e-6, False),
    ("trace/comm_rate", 1e-7, False),     # every other array is bitwise
])
def test_merge_holds_overlaps_bitwise_except_j_final(tmp_path, key, delta, ok):
    st = tstore.SweepStore(tmp_path)
    a = _arrays((1e-3, 1e-2))
    b = _arrays((1e-2, 1e-1))
    b[key] = b[key].copy()
    b[key][:, 0] = b[key][:, 0] * (1 + delta) + (delta if key.endswith(
        "comm_rate") else 0)
    st.put(_spec((1e-3, 1e-2)), a, AXES)
    st.put(_spec((1e-2, 1e-1)), b, AXES)
    entries = st.family(_spec((1e-3,)))
    if ok:
        assert st.merge(entries).lambdas == [1e-3, 1e-2, 1e-1]
    else:
        with pytest.raises(ValueError, match="differs"):
            st.merge(entries)


def test_merge_refuses_other_families_and_inputs(tmp_path):
    st = tstore.SweepStore(tmp_path)
    st.put(_spec((1e-3,)), _arrays((1e-3,)), AXES,
           extra={"inputs_digest": "a"})
    st.put(_spec((1e-2,)), _arrays((1e-2,)), AXES,
           extra={"inputs_digest": "b"})
    st.put(_spec((1e-1,), tag="other"), _arrays((1e-1,)), AXES)
    entries = [st.get(h) for h in st.hashes()]
    with pytest.raises(ValueError, match="families|different sweep inputs"):
        st.merge(entries)
    with pytest.raises(ValueError, match="nothing to merge"):
        st.merge([])
