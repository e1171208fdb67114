"""The port's six examples (``examples/torch_*.py``) against the
reference's (``examples/*.py``), on the CPU.

- quickstart: the port's printed lines are the reference script's, line
  for line (the reference runs in this process; it writes no file).
- sweep_queries and heterogeneity_report: the reference script's own
  source runs with its store root moved to a temporary directory, the
  port's ``main`` with ``--root`` in another; the printed budget answers,
  J means, Pareto front, budget vector, registry stats, chunk and GC
  lines are the reference's, their J within float32 noise (the spec
  hashes differ by design: the port's specs carry ``framework:
  "torch"``), and a second port run computes nothing.
- serve_batched: the prompt is the reference's ``randint`` bit for bit;
  each arch's reduced model, with the reference's ``model.init(key(0))``
  weights carried across by ``convert.model_from_jax``, decodes through
  the example's ``decode`` to the reference loop's greedy tokens.  A
  token where the reference's top two logits are within ``NEAR_TIE`` may
  go either way: it is reported (a warning), not failed, and the
  comparison stops there.
- federated_lm_training and train_100m: the reference's library steps
  (``build_train_step`` on 8 and 4 forced host devices, in two
  subprocesses) against the examples' ``train`` on the same weights and
  batches at a cut size: losses within ``LOSS_RTOL``, comm rates equal and
  decisions exact but where a gain lies within ``GAIN_TIE`` of its
  threshold; train_100m's parameter count equals the reference's, taken
  from ``jax.eval_shape``.
"""

import contextlib
import dataclasses
import io
import math
import os
import re
import subprocess
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from study_parity import ExecSpy, one_thread  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
sys.path.insert(0, EXAMPLES)

import torch_federated_lm_training as t_fed  # noqa: E402
import torch_heterogeneity_report as t_het  # noqa: E402
import torch_quickstart as t_quick  # noqa: E402
import torch_serve_batched as t_serve  # noqa: E402
import torch_sweep_queries as t_queries  # noqa: E402
import torch_train_100m as t_100m  # noqa: E402

NEAR_TIE = 1e-4          # top-two logit margin a greedy token may flip on
LOSS_RTOL = 1e-4
GAIN_TIE = 1e-3          # |gain + threshold| a decision may flip on
LM_STEPS = 3
LM_CUT = dict(fed=dict(seq=64, batch=8), t100=dict(seq=64, batch=4))


def _printed(fn, *args, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), one_thread():
        ret = fn(*args, **kw)
    return ret, out.getvalue().splitlines()


def _run_reference_script(name, root=None):
    """The reference example's own source, its store root moved to
    ``root``; returns its printed lines."""
    path = os.path.join(EXAMPLES, f"{name}.py")
    with open(path) as f:
        src = f.read()
    if root is not None:
        src, n = re.subn(r"^ROOT = os\.path\.join\(.*?\)\n",
                         f"ROOT = {root!r}\n", src, count=1,
                         flags=re.S | re.M)
        assert n == 1
    out = io.StringIO()
    with contextlib.redirect_stdout(out), one_thread():
        exec(compile(src, path, "exec"), {"__file__": path,
                                          "__name__": "__main__"})
    return out.getvalue().splitlines()


# ------------------------------------------------------------ quickstart ---


def test_quickstart_prints_the_reference_lines():
    want = _run_reference_script("quickstart")
    got_numbers, got = _printed(t_quick.main, ["--device", "cpu"])
    assert got == want
    assert set(got_numbers["runs"]) == set(t_quick.LAMBDAS)
    rates = [got_numbers["runs"][lam]["comm_rate"] for lam in t_quick.LAMBDAS]
    assert rates == sorted(rates, reverse=True)


def test_examples_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod in (t_quick, t_serve, t_queries, t_het, t_fed, t_100m):
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])


# ------------------------------------------------- store-backed examples ---


def _without(lines, *patterns):
    return [l for l in lines if not any(re.search(p, l) for p in patterns)]


NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")


def _same_lines(got, want):
    """The same lines but for their numbers, which agree within J's float32
    noise (1e-6 absolute plus 1e-4 relative, the studies' J tolerance:
    the garnet and gridworld J come from the exact problem's terms, a
    difference of float32 sums each framework orders its own way) or one
    unit of the last printed digit."""
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            x, y = float(a), float(b)
            digits = b.split("e")[0].partition(".")[2]
            unit = 10.0 ** -len(digits) * (10.0 ** int(b.split("e")[1])
                                           if "e" in b else 1.0)
            assert abs(x - y) <= 1e-6 + 1e-4 * abs(y) + unit, (g, w)


def test_sweep_queries_prints_the_reference_answers(tmp_path):
    want = _run_reference_script("sweep_queries", str(tmp_path / "jax"))
    out, got = _printed(t_queries.main, ["--device", "cpu", "--root",
                                         str(tmp_path / "torch")])
    # the spec hash and the store path are the port's own
    skip = (r"^sweep [0-9a-f]{12}… in store", r"serve_sweeps")
    _same_lines(_without(got, *skip), _without(want, *skip))
    assert out["chunks"] == [False] * 6
    again, lines = _printed(t_queries.main, ["--device", "cpu", "--root",
                                             str(tmp_path / "torch")])
    assert again["chunks"] == [True] * 6            # resumed, bitwise
    assert again["best"] == out["best"]


def test_heterogeneity_report_prints_the_reference_numbers(tmp_path,
                                                           monkeypatch):
    want = _run_reference_script("heterogeneity_report", str(tmp_path / "jax"))
    root = str(tmp_path / "torch")
    out, got = _printed(t_het.main, ["--device", "cpu", "--root", root])
    # artifact names carry the port's entry hashes; the GC lines' bytes
    # are the port's own npz files
    skip = (r"^report artifacts:", r"^gc ")
    _same_lines(_without(got, *skip), _without(want, *skip))
    def gc_lines(lines):
        return [re.sub(r" bytes=\d+", "", l) for l in lines
                if l.startswith("gc ")]
    assert gc_lines(got) == gc_lines(want)
    assert len(out["artifacts"]) == sum(
        l.count(".json") for l in want if l.startswith("report artifacts:"))
    spy = ExecSpy(monkeypatch)
    again, _ = _printed(t_het.main, ["--device", "cpu", "--root", root])
    assert spy.calls == 0                  # a second run computes nothing
    assert again["J"] == out["J"] and again["best"] == out["best"]
    assert not any(s["collected"] for s in again["gc"].values())


# ------------------------------------------------------------- serving ---


def _ref_decode(cfg, params):
    """The reference example's loop on the reference's library."""
    from repro.models import build_model as jbuild
    B, P, G = t_serve.BATCH, t_serve.PROMPT, t_serve.GEN
    model = jbuild(cfg)
    prompt = jax.random.randint(jax.random.key(1), (B, P), 0,
                                cfg.vocab_size, dtype=jnp.int32)
    step = jax.jit(model.decode_step)
    cache = model.init_cache(B, P + G)
    for t in range(P):
        logits, cache = step(params, cache, prompt[:, t], jnp.int32(t))
    toks, all_logits = [], []
    cur = jnp.argmax(logits, -1).astype(jnp.int32)
    for t in range(P, P + G):
        toks.append(cur)
        all_logits.append(np.asarray(logits, np.float32))
        logits, cache = step(params, cache, cur, jnp.int32(t))
        cur = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.asarray(prompt), np.stack([np.asarray(t) for t in toks], 1), \
        np.stack(all_logits, 1)


@pytest.mark.parametrize("arch", t_serve.ARCHS)
def test_serve_batched_decodes_the_reference_tokens(arch):
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild
    from repro_torch.configs import get_config
    from repro_torch.convert import model_from_jax
    jcfg = jget_config(arch).reduced()
    params = jbuild(jcfg).init(jax.random.key(0))
    prompt, want, logits = _ref_decode(jcfg, params)
    cfg = get_config(arch).reduced()
    assert np.array_equal(t_serve.prompt_tokens(cfg, "cpu").numpy(), prompt)
    model = model_from_jax(cfg, jax.tree.map(np.asarray, params),
                           device="cpu")
    with one_thread():
        got = t_serve.decode(model, cfg, "cpu")["tokens"].numpy()
    assert got.shape == want.shape == (t_serve.BATCH, t_serve.GEN)
    for b in range(t_serve.BATCH):
        diff = np.flatnonzero(got[b] != want[b])
        if diff.size:
            t = int(diff[0])
            top2 = np.sort(logits[b, t])[-2:]
            margin = float(top2[1] - top2[0])
            assert margin <= NEAR_TIE * max(1.0, abs(float(top2[1]))), (
                f"{arch} row {b} token {t}: port {got[b, t]}, reference "
                f"{want[b, t]} at a top-two margin of {margin:.3g}")
            warnings.warn(f"{arch} row {b}: a greedy near-tie at token {t} "
                          f"(margin {margin:.3g}); compared up to it")


def test_serve_batched_main_prints_one_line_an_arch():
    out, lines = _printed(t_serve.main, ["--device", "cpu"])
    assert [l.split()[0] for l in lines] == list(t_serve.ARCHS)
    assert [out[a]["cache"] for a in t_serve.ARCHS] == [
        "dense-KV", "ring[64]", "recurrent-state"]
    assert all(math.isfinite(out[a]["tokens_per_s"]) for a in t_serve.ARCHS)


# ------------------------------------------------------------ training ---

REF_LM = r"""
import sys
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.core.fed_sgd import FedConfig, FedStats
from repro.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_train_step
from repro.models import build_model
from repro.optim import adamw, cosine_schedule

which, steps, seq, batch, out = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), int(sys.argv[4]),
                                 sys.argv[5])
if which == "fed":        # examples/federated_lm_training.py
    cfg = get_config("olmoe-1b-7b").reduced()
    fed = FedConfig(eps=1.0, lam=3e-4, rho=0.995, horizon=40,
                    estimator="hvp")
    opt, key = adamw(3e-4), 1
else:                     # examples/train_100m.py, at the reduced config
    cfg = get_config("mamba2-370m").reduced()
    fed = FedConfig(eps=1.0, lam=1e-4, rho=0.999, horizon=steps,
                    estimator="gnorm")
    opt = adamw(cosine_schedule(3e-4, warmup=max(steps // 10, 1),
                                total=steps))
    key = 2
model = build_model(cfg)
mesh = make_host_mesh(model_axis=1)
bundle = build_train_step(model, cfg, mesh, opt, fed_cfg=fed)
params = model.init(jax.random.key(0))
rec = {}
for path, x in jax.tree_util.tree_leaves_with_path(params):
    rec["p0" + jax.tree_util.keystr(path)] = np.asarray(x, np.float32)
params = jax.device_put(params, jax.tree.map(
    lambda s: NamedSharding(mesh, s), bundle.pspecs))
opt_state, fed_state = opt.init(params), FedStats.init(bundle.num_agents)
lm = SyntheticLMConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch)
for s in range(steps):
    b = make_lm_batch(lm, jax.random.key(key), s)
    params, opt_state, fed_state, m = bundle.step(params, opt_state,
                                                  fed_state, b)
    rec[f"loss{s}"] = np.asarray(m["loss"])
    rec[f"rate{s}"] = np.asarray(m["comm_rate"])
    rec[f"alpha{s}"] = np.asarray(fed_state.last_alpha)
    rec[f"gain{s}"] = np.asarray(fed_state.last_gain)
    rec[f"thr{s}"] = np.asarray(fed.threshold(s))
np.savez(out, **rec)
print("REF-LM-OK")
"""


def _tree(rec, prefix):
    """The reference's flat ``keystr`` leaves -> its nested tree."""
    tree = {}
    for key, v in rec.items():
        if key.startswith(prefix + "["):
            parts = [p.strip("'\"")
                     for p in key[len(prefix) + 1:-1].split("][")]
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    return tree


@pytest.fixture(scope="module")
def reference_lm(tmp_path_factory):
    """Both examples' reference steps, in two concurrent subprocesses on 8
    and 4 forced host devices (the examples' own counts)."""
    root = tmp_path_factory.mktemp("ref_lm")
    procs = {}
    for which, devices in (("fed", t_fed.AGENTS), ("t100", t_100m.AGENTS)):
        cut = LM_CUT[which]
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS=f"--xla_force_host_platform_device_count="
                             f"{devices}")
        out = str(root / f"{which}.npz")
        procs[which] = (out, subprocess.Popen(
            [sys.executable, "-c", REF_LM, which, str(LM_STEPS),
             str(cut["seq"]), str(cut["batch"]), out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=REPO, env=env))
    recs = {}
    for which, (out, p) in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0 and "REF-LM-OK" in stdout, stderr[-3000:]
        recs[which] = dict(np.load(out))
    return recs


def _check_steps(ref, history, agents):
    ties = []
    for s in range(LM_STEPS):
        got = next(h for h in history if h["step"] == s)
        np.testing.assert_allclose(got["loss"], ref[f"loss{s}"],
                                   rtol=LOSS_RTOL)
        near = np.abs(ref[f"gain{s}"] + ref[f"thr{s}"]) <= GAIN_TIE
        ties += [(s, i) for i in np.flatnonzero(near)]
        if "last_alphas" in got:
            alphas = np.asarray(got["last_alphas"])
            np.testing.assert_array_equal(alphas[~near[:8]],
                                          ref[f"alpha{s}"][:8][~near[:8]])
        if not ties:
            assert got["comm_rate"] == pytest.approx(float(ref[f"rate{s}"]),
                                                     abs=1e-6)
    if ties:
        warnings.warn(f"decision near-ties (gain within {GAIN_TIE} of the "
                      f"threshold): {ties}")
    assert ref["alpha0"].shape == (agents,)


def _every_step(mod, cfg, ref, cut, lines=None):
    """The example's ``train`` on the reference's weights, logging every
    step: its history."""
    from repro_torch.convert import model_from_jax
    model = model_from_jax(cfg, _tree(ref, "p0"), device="cpu")
    with one_thread():
        out = mod.train(model, cfg, steps=LM_STEPS, seq_len=cut["seq"],
                        global_batch=cut["batch"], device="cpu",
                        log=(lines.append if lines is not None
                             else lambda line: None), log_every=1)
    assert [h["step"] for h in out["history"]] == list(range(LM_STEPS))
    return out["history"]


def test_federated_lm_training_steps_as_the_reference(reference_lm):
    from repro_torch.configs import get_config
    ref = reference_lm["fed"]
    cfg = get_config(t_fed.ARCH).reduced()
    lines = []
    hist = _every_step(t_fed, cfg, ref, LM_CUT["fed"], lines)
    assert lines[0].startswith("step   0  loss ")
    assert "exchanges skipped" in lines[-1]
    _check_steps(ref, hist, t_fed.AGENTS)


def test_train_100m_steps_as_the_reference_at_the_reduced_config(
        reference_lm):
    from repro_torch.configs import get_config
    ref = reference_lm["t100"]
    cfg = get_config("mamba2-370m").reduced()
    _check_steps(ref, _every_step(t_100m, cfg, ref, LM_CUT["t100"]),
                 t_100m.AGENTS)


def test_train_100m_param_count_is_the_reference_count():
    from repro.configs import get_config as jget_config
    from repro.models import build_model as jbuild
    from repro_torch.models import build_model
    jcfg = dataclasses.replace(jget_config("mamba2-370m"), num_layers=8,
                               dtype="float32", remat=False, loss_chunk=128)
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.key(0))
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    cfg = t_100m.config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = build_model(cfg, "cpu")
    assert t_100m.param_count(model) == want
    assert 95e6 < want < 110e6
