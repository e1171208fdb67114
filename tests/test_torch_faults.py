"""repro_torch.faults and its ten sites, held against repro.faults.

* ``parse_rules`` gives the reference's rules, and refuses the specs the
  reference refuses, naming the port's own variable;
* one sequence of ``scope`` / ``event`` calls fires the same rules in
  the same order in both packages, and ``truncate_half`` / ``flip_bit``
  leave the same bytes;
* each of the ten ``SITES`` fires at its place in the port (raise mode);
* raise-mode durability cells of ``benchmarks/torch_chaos.py`` recover
  bitwise against a clean port run, and two hard-crash cells
  (``os._exit(43)`` in a subprocess) do too.
"""

import os
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as jfaults  # noqa: E402

from benchmarks import torch_chaos  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.checkpoint import store as tckpt  # noqa: E402
from repro_torch.experiments.client import (QueryServiceClient,  # noqa: E402
                                            RetryPolicy)
from repro_torch.experiments.registry import (  # noqa: E402
    EntryUnavailableError, StoreRegistry)
from repro_torch.experiments.serve_sweeps import make_handler  # noqa: E402
from repro_torch.experiments.store import SweepStore  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean_plans():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# ------------------------------------------------------------- parsing -----


def test_constants_match_reference():
    assert faults.SITES == jfaults.SITES
    assert faults.KINDS == jfaults.KINDS
    assert faults.CRASH_EXIT == jfaults.CRASH_EXIT == 43
    assert (faults.ENV_VAR, faults.ENV_CRASH, faults.ENV_LATENCY) == (
        "REPRO_TORCH_FAULTS", "REPRO_TORCH_FAULTS_CRASH",
        "REPRO_TORCH_FAULTS_LATENCY_S")


@pytest.mark.parametrize("spec", [
    "ckpt.write:torn:1, store.commit:crash-after:2",
    "runtime.gc:crash_before",
    "serve.request:latency:3,registry.load:oserror:1,,",
    " store.merge : flip : 7 ",
    "",
])
def test_parse_rules_matches_reference(spec):
    got = [(r.site, r.kind, r.nth, r.fired) for r in faults.parse_rules(spec)]
    want = [(r.site, r.kind, r.nth, r.fired)
            for r in jfaults.parse_rules(spec)]
    assert got == want


@pytest.mark.parametrize("spec", [
    "nope.site:torn:1",          # unknown site
    "ckpt.write:melt:1",         # unknown kind
    "ckpt.write:torn:0",         # nth must be >= 1
    "ckpt.write:torn:x",         # nth not an integer
    "ckpt.write",                # missing kind
    "ckpt.write:torn:1:2",       # too many fields
])
def test_parse_rules_refuses_what_reference_refuses(spec):
    with pytest.raises(ValueError) as want:
        jfaults.parse_rules(spec)
    with pytest.raises(ValueError, match="REPRO_TORCH_FAULTS") as got:
        faults.parse_rules(spec)
    assert str(got.value).replace("REPRO_TORCH_FAULTS", "REPRO_FAULTS") \
        == str(want.value)


def test_env_var_is_the_ports_own(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "store.commit:oserror:1")
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    faults.reset()
    assert faults.active() is None         # the reference's rule is not ours
    monkeypatch.setenv(faults.ENV_VAR, "store.commit:oserror:1")
    faults.reset()
    plan = faults.active()
    assert plan is not None and plan.rules[0].site == "store.commit"


# ----------------------------------------------------- firing parity -----

SEQUENCE_RULES = ("ckpt.write:torn:1,ckpt.write:crash_after:2,"
                  "store.commit:oserror:2,store.commit:flip:3,"
                  "runtime.gc:latency:1,serve.request:crash_before:3,"
                  "registry.load:flip:1,runtime.lock:crash_after:1")
SEQUENCE_SITES = ("ckpt.write", "store.commit", "runtime.gc",
                  "serve.request", "registry.load", "runtime.lock")


def _drive(mod, work):
    """Three rounds over SEQUENCE_SITES under SEQUENCE_RULES: what each
    occurrence did, the plan's firing log and counters, and the bytes of
    every file handed to ``mangle``."""
    os.makedirs(work)
    plan = mod.install(SEQUENCE_RULES, crash_mode="raise")
    plan.latency_s = 0.0
    outcomes = []
    for rnd in range(3):
        for site in SEQUENCE_SITES:
            path = os.path.join(work, f"{site}-{rnd}.bin")
            with open(path, "wb") as f:
                f.write(bytes(range(256)) * 2)
            try:
                with mod.scope(site) as fs:
                    outcomes.append(fs.mangle(path))
            except mod.FaultInjected:
                outcomes.append("crash")
            except mod.TransientFault as e:
                outcomes.append(("oserror", e.errno, e.site))
        mod.event("runtime.unlock")
    blobs = {name: open(os.path.join(work, name), "rb").read()
             for name in sorted(os.listdir(work))}
    return outcomes, plan.fired, plan.counts, blobs


def test_scope_sequence_fires_as_reference(tmp_path):
    got = _drive(faults, str(tmp_path / "port"))
    want = _drive(jfaults, str(tmp_path / "ref"))
    assert got == want
    assert {f["kind"] for f in got[1]} == set(faults.KINDS)


def test_crash_is_a_base_exception_and_spares_raising_scopes():
    assert not issubclass(faults.FaultInjected, Exception)
    faults.install("ckpt.write:crash_after:1")
    with pytest.raises(RuntimeError, match="inner"):
        with faults.scope("ckpt.write"):
            raise RuntimeError("inner")


@pytest.mark.parametrize("size,name", [
    (1, "a.bin"), (3, "arrays.npz"), (128, "chunk_000001.npz"),
    (129, "chunk_000001.npz"), (4097, "meta.json")])
def test_corruption_helpers_match_reference(tmp_path, size, name):
    blob = np.random.default_rng(size).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    out = {}
    for tag, mod in (("port", faults), ("ref", jfaults)):
        d = tmp_path / tag
        d.mkdir()
        (d / name).write_bytes(blob)
        (d / ("t-" + name)).write_bytes(blob)
        offset = mod.flip_bit(str(d / name))
        mod.truncate_half(str(d / ("t-" + name)))
        out[tag] = (offset, (d / name).read_bytes(),
                    (d / ("t-" + name)).read_bytes())
    assert out["port"] == out["ref"]
    assert out["port"][1] != blob
    assert len(out["port"][2]) == max(1, size // 2)


def test_quarantine_never_overwrites_evidence(tmp_path):
    for k in range(2):
        p = tmp_path / "arrays.npz"
        p.write_bytes(bytes([k]))
        assert faults.quarantine_path(str(p), f"incident {k}").endswith(
            f".quarantined-{k}")


# ------------------------------------------- each site fires in the port ---


def _tree():
    return {"w": torch.arange(6, dtype=torch.float32), "n": torch.tensor(3)}


def _sweep(root, mode="sweep"):
    torch_chaos.child_main(mode, str(root), True, CPU)


def _site_ckpt(tmp_path, site):
    path = str(tmp_path / "c.npz")
    with pytest.raises(faults.FaultInjected):
        tckpt.save(path, _tree(), durable=True)
    # before the rename nothing is published; the fsync follows it
    assert os.path.exists(path) == (site == "ckpt.fsync")
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def _site_store(tmp_path, site):
    s = SweepStore(str(tmp_path / "store"))
    spec = {"modes": ["theoretical"], "lambdas": [0.1], "rhos": [0.9],
            "seeds": [0], "tag": "site"}
    arrays = {"trace/comm_rate": np.ones((1, 1), np.float32)}
    if site == "store.merge":
        faults.reset()
        h = s.put(spec, arrays, ("mode", "lam"))
        faults.install(f"{site}:crash_before:1")
        with pytest.raises(faults.FaultInjected):
            s.merge([s.get(h)])
        return
    with pytest.raises(faults.FaultInjected):
        s.put(spec, arrays, ("mode", "lam"))
    assert s.hashes() == []


def _site_runtime(tmp_path, site):
    root = tmp_path / "run"
    if site == "runtime.gc":
        faults.reset()
        _sweep(root)
        faults.install(f"{site}:crash_before:1")
        with pytest.raises(faults.FaultInjected):
            _sweep(root, "gc")
        assert [n for n in os.listdir(root / "chunks")
                if n.startswith("chunk_")]
        return
    with pytest.raises(faults.FaultInjected):
        _sweep(root)
    lock = os.path.exists(root / "chunks" / "INCOMPLETE")
    committed = bool(SweepStore(str(root / "store")).hashes())
    # lock: crashed before the lock exists; unlock: the record committed
    # under a live lock
    assert (lock, committed) == ((False, False) if site == "runtime.lock"
                                 else (True, True))


def _site_registry(tmp_path, site):
    root = str(tmp_path / "store")
    s = SweepStore(root)
    h = s.put({"modes": ["theoretical"], "lambdas": [0.1, 1.0],
               "rhos": [0.9], "seeds": [0], "tag": "site"},
              {"trace/comm_rate": np.asarray([[0.5, 0.2]], np.float32)},
              ("mode", "lam"))
    faults.reset()
    faults.install(f"{site}:oserror:1")
    with pytest.raises(EntryUnavailableError) as ei:
        StoreRegistry(root).table(h)
    assert ei.value.spec_hash == h and "injected" in ei.value.reason


def _site_serve(tmp_path, site):
    root = str(tmp_path / "store")
    h = SweepStore(root).put(
        {"modes": ["theoretical"], "lambdas": [0.1, 1.0], "rhos": [0.9],
         "seeds": [0], "tag": "site"},
        {"trace/comm_rate": np.asarray([[0.5, 0.2]], np.float32)},
        ("mode", "lam"))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                make_handler(root, quiet=True))
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    try:
        faults.reset()
        plan = faults.install(f"{site}:oserror:1,{site}:oserror:3")
        with QueryServiceClient("127.0.0.1", httpd.server_address[1],
                                timeout=10, policy=RetryPolicy(
                                    base_s=0.001, seed=1)) as c:
            assert c.get("curve", hash=h)[0] == 200      # GET, one drop
            st, body = c.batch([{"query": "pareto", "hash": h}])  # POST
            assert st == 200 and body["count"] == 1
            assert c.stats["transient_retries"] == 2
        assert [f["n"] for f in plan.fired] == [1, 3]
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.join(timeout=10)


SITE_CHECKS = {
    "ckpt.write": _site_ckpt, "ckpt.rename": _site_ckpt,
    "ckpt.fsync": _site_ckpt, "store.commit": _site_store,
    "store.merge": _site_store, "runtime.lock": _site_runtime,
    "runtime.unlock": _site_runtime, "runtime.gc": _site_runtime,
    "registry.load": _site_registry, "serve.request": _site_serve,
}


@pytest.mark.parametrize("site", faults.SITES)
def test_each_site_fires_at_its_port_location(tmp_path, site):
    assert set(SITE_CHECKS) == set(faults.SITES)
    plan = faults.install(f"{site}:crash_before:1")
    SITE_CHECKS[site](tmp_path, site)
    assert any(f["site"] == site for f in faults.active().fired + plan.fired)


# ------------------------------------------- bitwise recovery, raise mode --


@pytest.fixture(scope="module")
def clean_digests(tmp_path_factory):
    """A clean port run of each child mode the cells use (CPU)."""
    out = {}
    for key, modes in (("sweep", ("sweep",)), ("extend", ("sweep", "extend"))):
        root = str(tmp_path_factory.mktemp(f"clean_{key}"))
        for mode in modes:
            assert not torch_chaos.in_process(mode, root, True, CPU)
        out[key] = torch_chaos.entry_digest(
            os.path.join(root, "store"), torch_chaos.cell_hash(True, key))
    return out


RAISE_CELLS = [c for c in torch_chaos.DURABILITY_CELLS
               if (c[0], c[1]) in {("ckpt.write", "torn"),
                                   ("store.commit", "torn"),
                                   ("store.merge", "crash_before"),
                                   ("runtime.unlock", "crash_before"),
                                   ("runtime.gc", "crash_before")}]


@pytest.mark.parametrize("cell", RAISE_CELLS, ids=lambda c: f"{c[0]}:{c[1]}")
def test_raise_mode_cell_recovers_bitwise(tmp_path, clean_digests, cell):
    site, kind, spec, mode = cell
    root = str(tmp_path / "cell")
    seed = torch_chaos.seed_mode(mode)
    if seed:
        assert not torch_chaos.in_process(seed, root, True, CPU)
    crashed = torch_chaos.in_process(mode, root, True, CPU, spec)
    assert crashed == ("crash" in spec)
    assert not torch_chaos.in_process(mode, root, True, CPU)   # recovery
    key = "extend" if mode == "extend" else "sweep"
    got = torch_chaos.entry_digest(os.path.join(root, "store"),
                                   torch_chaos.cell_hash(True, key))
    assert got == clean_digests[key]
    if kind in ("torn", "flip"):       # the corrupt bytes were set aside
        assert torch_chaos.count_quarantined(root) >= 1
    if mode == "gc":
        chunks = os.path.join(root, "chunks")
        assert not os.path.isdir(chunks) or not [
            n for n in os.listdir(chunks) if n.startswith("chunk_")]


@pytest.mark.parametrize("spec", [
    "runtime.unlock:crash_before:1",
    "ckpt.write:torn:1,ckpt.write:crash_after:2"])
def test_hard_crash_child_recovers_bitwise(tmp_path, clean_digests, spec):
    root = str(tmp_path / "cell")
    rc, _, out = torch_chaos.spawn("sweep", root, True, CPU, spec)
    assert rc == faults.CRASH_EXIT, out
    rc, _, out = torch_chaos.spawn("sweep", root, True, CPU)
    assert rc == 0, out
    assert torch_chaos.entry_digest(
        os.path.join(root, "store"),
        torch_chaos.cell_hash(True, "sweep")) == clean_digests["sweep"]


def test_env_crash_is_a_hard_exit_43():
    """The real crash path: no exception, no finally blocks; and the
    port's module alone, with no torch."""
    code = ("import sys\n"
            "from repro_torch import faults\n"
            "assert 'torch' not in sys.modules\n"
            "try:\n"
            "    faults.event('store.commit')\n"
            "finally:\n"
            "    print('TEARDOWN RAN')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env[faults.ENV_VAR] = "store.commit:crash_before:1"
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == faults.CRASH_EXIT, proc.stderr
    assert "TEARDOWN RAN" not in proc.stdout


def test_committed_torch_chaos_rows_pass_the_gate():
    """experiments/bench/torch/chaos.json: the whole matrix from one card
    run, held by check_bench's chaos gate against the reference's rows."""
    import json
    from benchmarks.check_bench import check_suite
    bench = os.path.join(REPO, "experiments", "bench")
    with open(os.path.join(bench, "chaos.json")) as f:
        reference = json.load(f)
    with open(os.path.join(bench, "torch", "chaos.json")) as f:
        rows = json.load(f)
    assert check_suite("chaos", reference, rows) == []
    assert torch_chaos.gate(rows) == []
    durability = [r for r in rows if r["bench"] == "chaos"]
    assert [(r["site"], r["kind"], r["faults"]) for r in durability] == [
        c[:3] for c in torch_chaos.DURABILITY_CELLS]
    assert len(rows) - len(durability) == 5
    assert all(r["recovered_bitwise"] for r in durability)
    (card,) = {r["device"] for r in rows}      # one run, one card
    name, limit = card.rsplit(", ", 1)
    assert "H100" in name and limit.endswith(" W")
