"""repro_torch.experiments.runtime: the contracts of
tests/test_runtime_resume.py and the store-first entry points, on the port.

* a fresh ``run_sweep_resumable`` is bitwise ``run_sweep`` at the same
  ``chunk_size``; a sweep cut after k chunks and resumed is bitwise the
  uninterrupted one, for both traces, every step backend and a channel
  axis; a corrupt chunk is quarantined and recomputed;
* segments land in one preallocated accumulator, in place (the port's
  counterpart of the reference's donation);
* a store dir refuses another sweep; ``inputs_digest`` tells inputs apart;
* ``gc_finished``, ``run_sweep_extend`` and ``sweep_or_load`` keep the
  reference's rules; a second ``sweep_or_load`` computes nothing;
* the port's resumable summary result agrees with ``repro``'s.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.algorithm1 import ParamSampler as JPS  # noqa: E402
from repro.envs import garnet as jgarnet  # noqa: E402
from repro.experiments import runtime as jruntime  # noqa: E402
from repro.experiments import sweep as jsweep  # noqa: E402

from repro_torch.checkpoint import store as tckpt  # noqa: E402
from repro_torch.core.algorithm1 import ParamSampler  # noqa: E402
from repro_torch.core.channel import ChannelSpec  # noqa: E402
from repro_torch.envs import garnet as tgarnet  # noqa: E402
from repro_torch.experiments import runtime  # noqa: E402
from repro_torch.experiments import sweep as tsweep  # noqa: E402
from repro_torch.experiments.store import SweepStore, spec_hash  # noqa: E402

S, M, T, N = 8, 2, 6, 16
W0 = np.zeros(S, np.float32)
ENV = tgarnet.GarnetMDP(num_states=S, seed=3)
PROB = ENV.vfa_problem(W0)


def _spec(**kw):
    base = dict(modes=("theoretical", "practical", "random"),
                lambdas=(1e-3, 1e-1), seeds=(0, 1), rhos=(0.95,), eps=0.5,
                num_iterations=N, num_agents=M, random_tx_prob=0.4,
                chunk_size=4, trace="summary", step_backend="reference",
                gain_backend="kernel")
    base.update(kw)
    return tsweep.SweepSpec(**base)


def _sampler(w0=W0):
    return ParamSampler(ENV.sampler_fn(T), ENV.agent_params(w0, M))


def _resumable(spec, d, **kw):
    return runtime.run_sweep_resumable(spec, _sampler(), W0, PROB,
                                       store_dir=str(d), device="cpu", **kw)


def _run_sweep(spec):
    return tsweep.run_sweep(spec, _sampler(), W0, PROB, device="cpu")


def _chunk_files(store_dir):
    return sorted(f for f in os.listdir(store_dir) if f.startswith("chunk_"))


def _truncate_after(store_dir, k):
    """Simulate a crash after k completed chunks: later chunks vanish."""
    for f in _chunk_files(store_dir)[k:]:
        os.remove(os.path.join(store_dir, f))


def _assert_bitwise(got, ref):
    assert got.axes == ref.axes
    assert torch.equal(got.comm_rate, ref.comm_rate)
    assert torch.equal(got.j_final, ref.j_final)
    for name in type(ref.trace)._fields:
        a, b = getattr(got.trace, name), getattr(ref.trace, name)
        if b is None:
            assert a is None, name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f"trace.{name}"


def _events():
    log = []
    return log, lambda i, n, restored: log.append((i, n, restored))


# -------------------------------------------------------------- parity ----


def test_fresh_resumable_bitwise_matches_run_sweep(tmp_path):
    spec = _spec()
    got = _resumable(spec, tmp_path / "s")
    _assert_bitwise(got, _run_sweep(spec))
    assert len(_chunk_files(tmp_path / "s")) == 3          # 12 runs / 4
    assert not os.path.exists(tmp_path / "s" / "INCOMPLETE")


@pytest.mark.parametrize("step", ["reference", "fused", "megastep"])
@pytest.mark.parametrize("trace", ["summary", "full"])
def test_chunked_equals_unchunked_bitwise_on_cpu(step, trace):
    """On the CPU a chunk of runs gives the bytes of the whole batch."""
    spec = _spec(step_backend=step, trace=trace)
    _assert_bitwise(_run_sweep(spec),
                    _run_sweep(dataclasses.replace(spec, chunk_size=None)))


@pytest.mark.parametrize("step", ["reference", "fused", "megastep"])
@pytest.mark.parametrize("trace", ["summary", "full"])
def test_crash_resume_bitwise_identical(tmp_path, step, trace):
    """Cut after 1 of 3 chunks, resume: bitwise the uninterrupted run and
    run_sweep at the same chunk_size."""
    spec = _spec(step_backend=step, trace=trace)
    d = tmp_path / "s"
    ref = _resumable(spec, d)
    _truncate_after(d, 1)
    log, on_chunk = _events()
    got = _resumable(spec, d, on_chunk=on_chunk)
    assert log == [(0, 3, True), (1, 3, False), (2, 3, False)]
    _assert_bitwise(got, ref)
    _assert_bitwise(got, _run_sweep(spec))


def test_crash_resume_bitwise_with_channel_axis(tmp_path):
    chans = (ChannelSpec(), ChannelSpec(0.3, 1, 0), ChannelSpec(0.2, 0, 3))
    spec = _spec(step_backend="fused", channel_sets=chans, chunk_size=8)
    d = tmp_path / "s"
    ref = _resumable(spec, d)
    assert ref.axes == ("channel",) + tsweep.BASE_AXES
    assert len(_chunk_files(d)) == 5                      # 36 runs / 8
    _truncate_after(d, 2)
    log, on_chunk = _events()
    got = _resumable(spec, d, on_chunk=on_chunk)
    assert [r for *_, r in log] == [True, True, False, False, False]
    _assert_bitwise(got, ref)
    _assert_bitwise(got, _run_sweep(spec))
    assert ref.trace.delivered_counts is not None


def test_resume_loads_all_chunks_without_recompute(tmp_path, monkeypatch):
    spec = _spec()
    ref = _resumable(spec, tmp_path / "s")

    def boom(*a, **k):
        raise AssertionError("recomputed a finished segment")
    monkeypatch.setattr(runtime, "exec_plan_segment", boom)
    log, on_chunk = _events()
    got = _resumable(spec, tmp_path / "s", on_chunk=on_chunk)
    assert [r for *_, r in log] == [True, True, True]
    _assert_bitwise(got, ref)


def test_corrupt_chunk_is_quarantined_and_recomputed(tmp_path):
    spec = _spec(trace="full")
    d = tmp_path / "s"
    ref = _resumable(spec, d)
    path = d / _chunk_files(d)[1]
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    path.write_bytes(bytes(blob))
    log, on_chunk = _events()
    got = _resumable(spec, d, on_chunk=on_chunk)
    assert [r for *_, r in log] == [True, False, True]
    _assert_bitwise(got, ref)
    assert any(".quarantined-" in f for f in os.listdir(d))


def test_single_segment_without_chunk_size(tmp_path):
    spec = _spec(chunk_size=None)
    got = _resumable(spec, tmp_path / "s")
    assert _chunk_files(tmp_path / "s") == ["chunk_000000.npz"]
    _assert_bitwise(got, _run_sweep(spec))


def test_accumulator_is_written_in_place(tmp_path, monkeypatch):
    """Every segment lands in one preallocated accumulator: its storage
    never moves, and the result is a view of it."""
    ptrs = []
    scatter = runtime._scatter_segment

    def spy(acc, seg, start):
        before = [a.data_ptr() for a in acc if a is not None]
        out = scatter(acc, seg, start)
        ptrs.append((before, [a.data_ptr() for a in out if a is not None]))
        return out
    monkeypatch.setattr(runtime, "_scatter_segment", spy)
    got = _resumable(_spec(), tmp_path / "s")
    assert len(ptrs) == 3
    assert all(b == a == ptrs[0][0] for b, a in ptrs)
    assert got.trace.final_weights.data_ptr() == ptrs[0][0][0]


@pytest.mark.parametrize("kw", [
    dict(trace="full"), dict(trace="summary"),
    dict(trace=tsweep.TraceSpec(j_trajectory=True, alphas=True, gains=True)),
    dict(trace="summary", channel_sets=(ChannelSpec(0.5),)),
    dict(trace="full", channel_sets=(ChannelSpec(0.5),)),
])
def test_segment_shapes_match_an_executed_segment(kw):
    plan = tsweep.plan_sweep(_spec(**kw), _sampler(), W0, PROB, device="cpu")
    seg = tsweep.exec_plan_segment(plan, 0, plan.segment_runs)
    for name, s in tsweep.segment_shapes(plan)._asdict().items():
        x = getattr(seg, name)
        assert (s is None) == (x is None), name
        if x is not None:
            assert (tuple(x.shape), x.dtype) == (s.shape, s.dtype), name
    assert plan.segments() == [(a, a + 4) for a in
                               range(0, plan.padded_runs, 4)]
    with pytest.raises(ValueError, match="outside"):
        tsweep.exec_plan_segment(plan, 0, plan.padded_runs + 1)


# ------------------------------------------------------------ identity ----


def test_chunk_checkpoints_carry_identity_and_grid_coords(tmp_path):
    spec = _spec()
    _resumable(spec, tmp_path / "s")
    meta = tckpt.load_metadata(str(tmp_path / "s" / "chunk_000001.npz"))
    assert meta["spec_hash"] == spec_hash(spec)
    assert meta["segment"] == [4, 8] and meta["segment_index"] == 1
    assert meta["grid_coords"]["grid_shape"] == [3, 2, 1, 2]
    assert meta["inputs_digest"] == runtime.inputs_digest(_sampler(), W0, PROB)
    manifest = json.loads((tmp_path / "s" / "manifest.json").read_text())
    assert manifest["exec_hash"] == meta["exec_hash"]
    assert manifest["num_segments"] == 3


def test_store_dir_rejects_different_sweep(tmp_path):
    _resumable(_spec(), tmp_path / "s")
    with pytest.raises(ValueError, match="different sweep"):
        _resumable(_spec(lambdas=(1e-2,)), tmp_path / "s")


def test_inputs_digest_distinguishes_inputs():
    base = runtime.inputs_digest(_sampler(), W0, PROB)
    assert base == runtime.inputs_digest(_sampler(), torch.zeros(S), PROB)
    w1 = W0 + 0.5
    assert runtime.inputs_digest(_sampler(), w1, PROB) != base
    other = tgarnet.GarnetMDP(num_states=S, seed=4).vfa_problem(W0)
    assert runtime.inputs_digest(_sampler(), W0, other) != base
    assert runtime.inputs_digest(_sampler(w1), W0, PROB) != base
    assert runtime.inputs_digest(_sampler(), W0, None) != base
    # param_sets replace the sampler's own params, which then do not count
    sets = {k: v[None] for k, v in ENV.agent_params(W0, M).items()}
    assert (runtime.inputs_digest(_sampler(), W0, PROB, param_sets=sets)
            == runtime.inputs_digest(_sampler(w1), W0, PROB,
                                     param_sets=sets))


# --------------------------------------------------------------- store ----


def test_finished_sweep_lands_in_summary_store(tmp_path):
    spec = _spec()
    got = _resumable(spec, tmp_path / "s", summary_store=str(tmp_path / "st"))
    entry = SweepStore(tmp_path / "st").get(spec, verify=True)
    assert entry.extra["trace_kind"] == "summary"
    assert entry.extra["inputs_digest"] == runtime.inputs_digest(
        _sampler(), W0, PROB)
    _assert_bitwise(runtime.arrays_to_result(entry, "cpu"), got)


def test_gc_finished_lifecycle(tmp_path):
    d, st = tmp_path / "s", tmp_path / "st"
    assert runtime.gc_finished(str(d))["collected"] is False
    _resumable(_spec(), d, summary_store=str(st))
    (d / "INCOMPLETE").write_text("a crashed resume")
    with pytest.raises(RuntimeError, match="INCOMPLETE"):
        runtime.gc_finished(str(d))
    os.remove(d / "INCOMPLETE")
    stats = runtime.gc_finished(str(d))
    assert stats["collected"] and stats["files"] == 4 and not d.exists()
    assert runtime.gc_finished(str(d))["collected"] is False


def test_gc_finished_reclaims_a_stale_lock(tmp_path):
    """A crash between the store commit and the lock's removal."""
    d, st = tmp_path / "s", tmp_path / "st"
    _resumable(_spec(), d, summary_store=str(st))
    manifest = json.loads((d / "manifest.json").read_text())
    (d / "INCOMPLETE").write_text(manifest["exec_hash"])
    assert runtime.gc_finished(str(d))["collected"]


def test_gc_finished_refuses_foreign_and_mismatched(tmp_path):
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "chunk_000000.npz").write_bytes(b"x")
    with pytest.raises(LookupError, match="no manifest"):
        runtime.gc_finished(str(foreign))
    d, st = tmp_path / "s", SweepStore(tmp_path / "st")
    _resumable(_spec(), d)
    with pytest.raises(LookupError, match="without summary_store"):
        runtime.gc_finished(str(d))
    with pytest.raises(LookupError, match="no entry"):
        runtime.gc_finished(str(d), store=st)
    other = runtime.run_sweep_resumable(
        _spec(), _sampler(W0 + 1), W0, PROB, store_dir=str(tmp_path / "o"),
        summary_store=st, device="cpu")
    assert other is not None
    with pytest.raises(LookupError, match="different inputs"):
        runtime.gc_finished(str(d), store=st)


def test_run_sweep_extend_computes_only_missing_lambdas(tmp_path,
                                                        monkeypatch):
    st = SweepStore(tmp_path / "st")
    computed = []
    run = runtime.run_sweep

    def spy(spec, *a, **k):
        computed.append(spec.lambdas)
        return run(spec, *a, **k)
    monkeypatch.setattr(runtime, "run_sweep", spy)
    small = _spec(lambdas=(1e-3, 1e-1))
    runtime.run_sweep_extend(st, small, _sampler(), W0, PROB, device="cpu")
    big = _spec(lambdas=(1e-1, 1e-2, 1e-3))
    got = runtime.run_sweep_extend(st, big, _sampler(), W0, PROB,
                                   device="cpu", extra={"figure": "x"})
    assert computed == [(1e-3, 1e-1), (1e-2,)]
    # the requested order, each column as computed, and stored by hash
    want = _run_sweep(big)
    for name in ("tx_counts", "comm_rate"):
        assert torch.equal(getattr(got.trace, name),
                           getattr(want.trace, name)), name
    torch.testing.assert_close(got.trace.j_final, want.trace.j_final,
                               rtol=1e-6, atol=0)
    assert st.get(big).extra["figure"] == "x"
    runtime.run_sweep_extend(st, big, _sampler(), W0, PROB, device="cpu")
    assert len(computed) == 2


def test_sweep_or_load_computes_nothing_the_second_time(tmp_path,
                                                        monkeypatch):
    st = str(tmp_path / "st")
    spec = _spec(channel_sets=(ChannelSpec(), ChannelSpec(0.5, 1, 1)))
    first = runtime.sweep_or_load(st, spec, _sampler(), W0, PROB,
                                  store_dir=str(tmp_path / "s"),
                                  device="cpu")
    _assert_bitwise(first, _run_sweep(spec))

    def boom(*a, **k):
        raise AssertionError("computed on a store hit")
    monkeypatch.setattr(runtime, "run_sweep_extend", boom)
    monkeypatch.setattr(tsweep, "_exec_block", boom)
    again = runtime.sweep_or_load(st, spec, _sampler(), W0, PROB,
                                  device="cpu")
    _assert_bitwise(again, first)
    with pytest.raises(ValueError, match="different inputs"):
        runtime.sweep_or_load(st, spec, _sampler(W0 + 1), W0, PROB,
                              device="cpu")


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for fn in (runtime.sweep_or_load, runtime.run_sweep_extend):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(str(tmp_path / "st"), _spec(), _sampler(), W0, PROB)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runtime.run_sweep_resumable(_spec(), _sampler(), W0, PROB,
                                    store_dir=str(tmp_path / "s"))


# ----------------------------------------------------- against repro ----


def test_resumable_summary_matches_reference(tmp_path):
    """The port's resumable run (megastep, kernel wrappers) against the
    reference's (reference backends) on the same inputs."""
    jenv = jgarnet.GarnetMDP(num_states=S, seed=3)
    jw0 = jnp.zeros(S)
    common = dict(modes=("theoretical", "practical", "random"),
                  lambdas=(1e-3, 1e-1), seeds=(0, 1), rhos=(0.95,), eps=0.5,
                  num_iterations=N, num_agents=M, random_tx_prob=0.4,
                  chunk_size=4, trace="summary",
                  channel_sets=None)
    jspec = jsweep.SweepSpec(**common, step_backend="reference",
                             gain_backend="reference")
    ref = jruntime.run_sweep_resumable(
        jspec, JPS(jenv.sampler_fn(T), jenv.agent_params(jw0, M)), jw0,
        problem=jenv.vfa_problem(jw0), store_dir=str(tmp_path / "j"))
    got = _resumable(tsweep.SweepSpec(**common, step_backend="megastep",
                                      gain_backend="kernel"), tmp_path / "t")
    np.testing.assert_array_equal(got.trace.tx_counts.numpy(),
                                  np.asarray(ref.trace.tx_counts))
    np.testing.assert_allclose(got.comm_rate.numpy(), np.asarray(ref.comm_rate),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.trace.final_weights.numpy(),
                               np.asarray(ref.trace.final_weights),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.j_final.numpy(), np.asarray(ref.j_final),
                               rtol=1e-4, atol=1e-5)
    gains = np.asarray(ref.trace.gain_mean)
    scale = np.abs(np.stack([np.asarray(ref.trace.gain_min),
                             np.asarray(ref.trace.gain_max)])).max(0)
    assert np.all(np.abs(got.trace.gain_mean.numpy() - gains)
                  <= 1e-5 * (scale.max(-1, keepdims=True) + 1.0))
