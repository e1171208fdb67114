"""The port's training path against the reference's.

- ``chunked_xent_loss`` (a chunk that divides L and one that pads) and
  each model's ``loss_fn`` (reduced mamba2-370m, yi-6b and yi-6b with 2 kv
  heads, the reference's parameters) at 1e-5; remat (per-block
  checkpointing) changes neither the loss, the gradient nor the curvature.
- The whole federated train step against the reference's own
  ``build_train_step``, run in a subprocess on 4 forced host devices (as
  tests/test_system.py does): 4 agents, 2 steps, adamw with weight decay,
  the ``hvp`` estimator and a lambda that gives a mix of decisions.
  Decisions are exact (a gain within ``TIE`` of its threshold would be
  reported as a tie, ROADMAP queue 3 item 3; none is); loss, grad norm,
  comm rate and tx within 1e-6; gains within ``REF_GAIN_TOL`` of their
  scale, the reference's own float32 ``vdot`` error at this size
  (tests/test_torch_fed_sgd.py); AdamW's moments (the aggregate gradient
  and its square, scaled) within ``MOMENT_TOL`` of their leaf's largest:
  1e-5 on the first step, 1e-4 on the second, whose gradients are taken
  at parameters that already carry the differences below.  Parameters are
  held element by element to ``PARAM_TOL`` plus what those moment
  tolerances can move Adam's update m^ / (sqrt(v^) + eps) by, summed over
  the steps (``_adam_bound``): Adam divides each element by its own RMS,
  so where the aggregate gradient is a near-cancelled sum (|g| ~ 1e-7
  here) a full-size update carries both frameworks' summation error,
  and elsewhere the bound is ~1e-6.
- lambda = 1e9 freezes the parameters bit for bit; lambda = 0 is the plain
  mean; the training driver runs to its final JSON; a checkpoint round
  trip (and the reference restores it); a kernel reached under autograd
  raises through the ``forward_only`` guard.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import restore as jrestore  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.layers import chunked_xent_loss as jxent  # noqa: E402

from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (model_from_jax, state_dict_from_jax,  # noqa: E402
                                 state_dict_to_jax, tree_from_state_dict)
from repro_torch.core import fed_sgd as tfed  # noqa: E402
from repro_torch.data.synthetic_lm import SyntheticLMConfig, make_lm_batch  # noqa: E402
from repro_torch.kernels import common as kcommon  # noqa: E402
from repro_torch.kernels import flash_attention as kflash  # noqa: E402
from repro_torch.kernels import ssd_scan as kssd  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import build_train_step, trainable_params  # noqa: E402
from repro_torch.models.layers import chunked_xent_loss  # noqa: E402
from repro_torch.optim import adamw, sgd  # noqa: E402
from repro_torch import random as trandom  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
AGENTS, STEPS, SEQ, BATCH = 4, 2, 32, 8
LR, WD = 1e-3, 0.01
FED = dict(eps=1.0, lam=2.0, rho=0.9, horizon=4, estimator="hvp")
TIE = 1e-3             # a gain this close to its threshold may flip
REF_GAIN_TOL = 1e-3    # of the gain's scale: the reference's float32 vdot
MOMENT_TOL = (1e-5, 1e-4)   # of the leaf's largest, by step
PARAM_TOL = 1e-6
B1, B2, ADAM_EPS = 0.9, 0.95, 1e-8     # adamw's defaults
CONFIGS = {"mamba2-370m": {}, "yi-6b": {}, "yi-6b-gqa": {"num_kv_heads": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the test workers share the cores, and torch's
    thread pool spinning beside them costs more than it gains at these
    sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(name):
    arch = name.removesuffix("-gqa")
    jc = dataclasses.replace(jget_config(arch).reduced(), **CONFIGS[name])
    tc = dataclasses.replace(get_config(arch).reduced(), **CONFIGS[name])
    return jc, tc


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# chunked cross-entropy and loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 5])          # 12 % 4 == 0, 12 % 5 != 0
def test_chunked_xent_loss(chunk):
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(2, 12, 16)).astype(np.float32)
    head = (0.3 * rng.normal(size=(16, 40))).astype(np.float32)
    targets = rng.integers(0, 40, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.2).astype(np.float32)
    want, want_g = jax.value_and_grad(jxent)(
        jnp.asarray(hidden), jnp.asarray(head), jnp.asarray(targets),
        jnp.asarray(mask), chunk)
    h = _t(hidden).requires_grad_(True)
    got = chunked_xent_loss(h, _t(head), _t(targets), _t(mask), chunk)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module", params=list(CONFIGS))
def loss_pair(request):
    jc, tc = _configs(request.param)
    jm = jbuild_model(jc)
    params = jm.init(jax.random.key(3))
    model = model_from_jax(tc, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jc.vocab_size, (2, 40)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, axis=1),
             "mask": np.ones((2, 40), np.float32)}
    batch["mask"][:, -1] = 0
    return jc, jm, params, tc, model, batch


def test_loss_fn_matches_reference(loss_pair):
    jc, jm, params, tc, model, batch = loss_pair
    want, wm = jm.loss_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gm = model.loss_fn({k: _t(v) for k, v in batch.items()})
    assert set(gm) == set(wm) == {"xent", "aux"}
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    np.testing.assert_allclose(float(gm["xent"]), float(wm["xent"]), rtol=TOL)


def test_loss_fn_under_remat_same_loss_grad_and_curvature(loss_pair):
    """Per-block checkpointing recomputes in the backward pass, also under
    double backward: the curvature term passes through it."""
    _, _, params, tc, _, batch = loss_pair
    tb = {k: _t(v) for k, v in batch.items()}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tc, remat=remat)
        model = model_from_jax(cfg, jax.tree.map(np.asarray, params),
                               device="cpu")
        model.requires_grad_(True)
        p = trainable_params(model)
        grad_fn = tfed.make_grad_fn(lambda q: model.loss_fn(tb)[0])
        g = {k: v.detach() for k, v in grad_fn(p).items()}
        ghg = tfed.curvature_dot(grad_fn, p, g)
        out[remat] = (float(model.loss_fn(tb)[0].detach()), g, float(ghg))
    (l0, g0, c0), (l1, g1, c1) = out[False], out[True]
    assert l0 == l1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=0)
    np.testing.assert_allclose(c1, c0, rtol=1e-6)


# ---------------------------------------------------------------------------
# the whole train step against the reference's build_train_step
# ---------------------------------------------------------------------------

REF_STEP = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.configs import get_config
from repro.core.fed_sgd import FedConfig, FedStats
from repro.data.synthetic_lm import SyntheticLMConfig, make_lm_batch
from repro.launch.mesh import make_host_mesh
from repro.launch.steps import build_train_step
from repro.models import build_model
from repro.optim import adamw

AGENTS, STEPS, SEQ, BATCH, LR, WD, FED, out = (
    {agents}, {steps}, {seq}, {batch}, {lr}, {wd}, {fed}, sys.argv[1])
assert jax.device_count() == AGENTS
cfg = get_config("mamba2-370m").reduced()
model = build_model(cfg)
mesh = make_host_mesh(1)
opt = adamw(LR, weight_decay=WD)
bundle = build_train_step(model, cfg, mesh, opt, fed_cfg=FedConfig(**FED))
params = model.init(jax.random.key(0))
rec = {{}}
def put(prefix, tree):
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        rec[prefix + jax.tree_util.keystr(path)] = np.asarray(x, np.float32)
put("p0", params)
params = jax.device_put(params, jax.tree.map(
    lambda s: NamedSharding(mesh, s), bundle.pspecs))
opt_state, fed_state = opt.init(params), FedStats.init(AGENTS)
lm = SyntheticLMConfig(cfg.vocab_size, SEQ, BATCH)
for s in range(STEPS):
    batch = make_lm_batch(lm, jax.random.key(1), s)
    params, opt_state, fed_state, metrics = bundle.step(
        params, opt_state, fed_state, batch)
    put(f"params{{s}}", params)
    put(f"mu{{s}}", opt_state.mu)
    put(f"nu{{s}}", opt_state.nu)
    for k, v in metrics.items():
        rec[f"metric{{s}}/{{k}}"] = np.asarray(v)
    for k in fed_state._fields:
        rec[f"fed{{s}}/{{k}}"] = np.asarray(getattr(fed_state, k))
np.savez(out, **rec)
print("REF-STEP-OK")
"""


@pytest.fixture(scope="module")
def reference_steps(tmp_path_factory):
    """The reference's 2 train steps, in one subprocess on 4 host devices."""
    out = str(tmp_path_factory.mktemp("ref_step") / "ref.npz")
    code = REF_STEP.format(agents=AGENTS, steps=STEPS, seq=SEQ, batch=BATCH,
                           lr=LR, wd=WD, fed=repr(FED))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={AGENTS}")
    r = subprocess.run([sys.executable, "-c", code, out], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=600)
    assert r.returncode == 0 and "REF-STEP-OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(out))


def _tree(rec, prefix):
    """The reference's flat ``keystr`` leaves -> its nested tree."""
    tree = {}
    for key, v in rec.items():
        if key.startswith(prefix + "["):
            parts = [p.strip("'\"") for p in key[len(prefix) + 1:-1].split("][")]
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
    return tree


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _adam_bound(s, mu, nu):
    """How far step s's update -lr m^ / (sqrt(v^) + eps) can move an element
    when m and v are off by MOMENT_TOL[s] of their leaf's largest
    (first-order in both)."""
    bc1, bc2 = 1 - B1 ** (s + 1), 1 - B2 ** (s + 1)
    dm = MOMENT_TOL[s] * np.abs(mu).max() / bc1
    dv = MOMENT_TOL[s] * np.abs(nu).max() / bc2
    r = np.sqrt(nu / bc2)
    return LR * (dm / (r + ADAM_EPS) + np.abs(mu) / bc1 * dv
                 / (2 * np.maximum(r, ADAM_EPS) * (r + ADAM_EPS) ** 2))


def test_train_step_matches_reference(reference_steps):
    ref = reference_steps
    tc = get_config("mamba2-370m").reduced()
    model = model_from_jax(tc, _tree(ref, "p0"), device="cpu")
    opt = adamw(LR, weight_decay=WD)
    fed_cfg = tfed.FedConfig(**FED)
    bundle = build_train_step(model, tc, opt, fed_cfg=fed_cfg,
                              num_agents=AGENTS, device="cpu")
    params = trainable_params(model)
    opt_state, fed_state = opt.init(params), tfed.FedStats.init(AGENTS)
    lm = SyntheticLMConfig(tc.vocab_size, SEQ, BATCH)
    ties, bound = [], {}
    for s in range(STEPS):
        thr = float(fed_cfg.threshold(s))
        batch = make_lm_batch(lm, trandom.key(1), s)
        params, opt_state, fed_state, metrics = bundle.step(
            params, opt_state, fed_state, batch)
        want_gain = ref[f"fed{s}/last_gain"]
        want_alpha = ref[f"fed{s}/last_alpha"]
        near = np.abs(want_gain + thr) <= TIE
        ties += [(s, i) for i in np.flatnonzero(near)]
        got_alpha = fed_state.last_alpha.numpy()
        np.testing.assert_array_equal(got_alpha[~near], want_alpha[~near])
        scale = 1.0 + np.abs(want_gain).max()      # eps ||g||^2 <= 1: clipped
        np.testing.assert_allclose(fed_state.last_gain.numpy(), want_gain,
                                   atol=REF_GAIN_TOL * scale, rtol=0)
        assert int(fed_state.steps) == int(ref[f"fed{s}/steps"]) == s + 1
        np.testing.assert_allclose(float(fed_state.tx), ref[f"fed{s}/tx"],
                                   rtol=1e-6)
        for k in ("loss", "grad_norm", "comm_rate"):
            np.testing.assert_allclose(float(metrics[k]), ref[f"metric{s}/{k}"],
                                       rtol=1e-6, err_msg=k)
        for name, got in (("mu", opt_state.mu), ("nu", opt_state.nu)):
            want = dict(_leaves(_tree(ref, f"{name}{s}")))
            for k, g in _leaves(state_dict_to_jax(got)):
                w = want[k]
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=MOMENT_TOL[s] * np.abs(w).max(),
                                           err_msg=f"{name}{s} {k}")
        want = dict(_leaves(_tree(ref, f"params{s}")))
        got = dict(_leaves(state_dict_to_jax(
            {k: v.detach() for k, v in params.items()})))
        mu = dict(_leaves(_tree(ref, f"mu{s}")))
        nu = dict(_leaves(_tree(ref, f"nu{s}")))
        for k, w in want.items():
            bound[k] = bound.get(k, 0.0) + _adam_bound(s, mu[k], nu[k])
            excess = np.abs(got[k] - w) - bound[k] - PARAM_TOL
            assert excess.max() <= 0, (s, k, excess.max())
    assert not ties, f"decision ties (gain within {TIE} of -threshold): {ties}"
    alphas = np.stack([ref[f"fed{s}/last_alpha"] for s in range(STEPS)])
    assert 0 < alphas.sum() < alphas.size, alphas         # a mix of decisions


def _reduced_model(seed=0):
    tc = get_config("mamba2-370m").reduced()
    jm = jbuild_model(jget_config("mamba2-370m").reduced())
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return tc, params


def _one_step(tc, params, fed_cfg, opt, agents=AGENTS):
    model = model_from_jax(tc, params, device="cpu")
    bundle = build_train_step(model, tc, opt, fed_cfg=fed_cfg,
                              num_agents=agents, device="cpu")
    p = trainable_params(model)
    st, fs = opt.init(p), tfed.FedStats.init(agents)
    batch = make_lm_batch(SyntheticLMConfig(tc.vocab_size, SEQ, BATCH),
                          trandom.key(1), 0)
    p, st, fs, metrics = bundle.step(p, st, fs, batch)
    return {k: v.detach().clone() for k, v in p.items()}, fs, metrics, batch


def test_huge_lambda_freezes_parameters_bitwise():
    tc, params = _reduced_model()
    before = {k: v.clone() for k, v in state_dict_from_jax(params).items()}
    for est in ("hvp", "gnorm"):
        after, fs, metrics, _ = _one_step(
            tc, params, tfed.FedConfig(lam=1e9, horizon=100, estimator=est),
            sgd(0.1))
        assert float(metrics["comm_rate"]) == 0.0
        assert not fs.last_alpha.any()
        for k, v in before.items():
            assert torch.equal(after[k], v), k


def test_zero_lambda_is_the_plain_mean():
    tc, params = _reduced_model()
    opt = sgd(0.1)
    a, fs_a, m_a, batch = _one_step(tc, params, tfed.FedConfig(lam=0.0), opt)
    b, fs_b, m_b, _ = _one_step(tc, params, None, opt)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert float(m_a["comm_rate"]) == float(m_b["comm_rate"]) == 1.0
    assert torch.equal(fs_a.last_alpha, torch.ones(AGENTS))
    # by hand: each agent's clipped gradient, their mean, one sgd step
    model = model_from_jax(tc, params, device="cpu")
    model.requires_grad_(True)
    p = trainable_params(model)
    rows = BATCH // AGENTS
    mean = {k: torch.zeros_like(v) for k, v in p.items()}
    for i in range(AGENTS):
        local = {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
        grads = torch.autograd.grad(model.loss_fn(local)[0], list(p.values()))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = min(1.0, 1.0 / float(norm))
        for k, g in zip(p, grads):
            mean[k] += g * scale / AGENTS
    for k, v in p.items():
        torch.testing.assert_close(a[k], v.detach() - 0.1 * mean[k],
                                   rtol=1e-6, atol=1e-7)


def test_hvp_subsample_step_runs_and_gates():
    tc, params = _reduced_model()
    fed = tfed.FedConfig(eps=1.0, lam=2.0, rho=0.9, horizon=4,
                         hvp_subsample=2, agg_dtype="bfloat16")
    _, fs, metrics, _ = _one_step(tc, params, fed, adamw(LR))
    assert np.isfinite(float(metrics["loss"]))
    assert 0.0 <= float(metrics["comm_rate"]) <= 1.0
    assert tuple(fs.last_gain.shape) == (AGENTS,)


def test_train_step_refuses_foreign_params_and_ragged_batches():
    tc, params = _reduced_model()
    model = model_from_jax(tc, params, device="cpu")
    opt = sgd(0.1)
    bundle = build_train_step(model, tc, opt, num_agents=3, device="cpu")
    p = trainable_params(model)
    batch = make_lm_batch(SyntheticLMConfig(tc.vocab_size, 8, 4),
                          trandom.key(0), 0)
    with pytest.raises(ValueError, match="does not split"):
        bundle.step(p, opt.init(p), tfed.FedStats.init(3), batch)
    other = {k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
    with pytest.raises(ValueError, match="own parameters"):
        bundle.step(other, opt.init(other), tfed.FedStats.init(3), batch)


# ---------------------------------------------------------------------------
# the driver, checkpoints, and the kernels' guard
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [["--steps", "6"],
                                   ["--steps", "4", "--lam", "1e-3",
                                    "--agents", "4", "--seq-len", "32",
                                    "--log-every", "1"]])
def test_train_driver_runs_to_final_json(extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-370m", "--reduced", "--device", "cpu", *extra],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("[train] arch=mamba2-370m-smoke agents=")
    final = json.loads(lines[-1])["final"]
    assert np.isfinite(final["loss"]) and 0.0 <= final["comm_rate"] <= 1.0
    assert final["step"] == int(extra[1]) - 1


def test_train_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(get_config("mamba2-370m").reduced(), steps=1)


def test_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "ck.npz")
    logs = []
    out = ttrain.train(get_config("mamba2-370m").reduced(), steps=2,
                       seq_len=16, global_batch=2, lam=1e-3, agents=2,
                       checkpoint=path, device="cpu", log=logs.append)
    assert logs[-1] == f"[train] checkpoint -> {path}"
    sd = out["model"].state_dict()
    like = tree_from_state_dict(sd)
    tree, meta = tckpt.restore(path, like)
    assert meta["arch"] == "mamba2-370m-smoke" and meta["steps"] == 2
    restored = state_dict_from_jax(tree)
    assert set(restored) == set(sd)
    for k, v in sd.items():
        assert torch.equal(restored[k], v), k
    # the reference's checkpoint code restores it into its own tree
    jm = jbuild_model(jget_config("mamba2-370m").reduced())
    jtree, _ = jrestore(path, jm.init(jax.random.key(0)))
    for k, v in _leaves(state_dict_to_jax(sd)):
        np.testing.assert_array_equal(
            np.asarray(dict(_leaves(jax.tree.map(np.asarray, jtree)))[k]), v)


@pytest.mark.parametrize("arch", ["mamba2-370m", "yi-6b"])
def test_kernel_under_autograd_raises_through_forward_only(arch, monkeypatch):
    """The plain path is what trains: ``loss_fn`` reaches no kernel, and a
    model left on its kernels under autograd hits the guard of a CUDA
    kernel instead of detaching.  There is no card here, so the wrappers
    are told their tensors lie on one and the guard is spied on."""
    calls = []
    real = kcommon.forward_only

    def spy(name, *tensors):
        calls.append(name)
        return real(name, *tensors)

    mod = kssd if arch == "mamba2-370m" else kflash
    monkeypatch.setattr(mod, "forward_only", spy)
    monkeypatch.setattr(mod, "on_cuda", lambda *t: True)
    tc = dataclasses.replace(get_config(arch).reduced(), remat=False)
    jm = jbuild_model(jget_config(arch).reduced())
    model = model_from_jax(tc, jax.tree.map(np.asarray, jm.init(
        jax.random.key(0))), device="cpu")
    model.requires_grad_(True)
    batch = make_lm_batch(SyntheticLMConfig(tc.vocab_size, 16, 1),
                          trandom.key(0), 0)
    assert model.use_kernels
    loss, _ = model.loss_fn(batch)          # the plain path: no kernel
    assert calls == [] and loss.requires_grad
    with pytest.raises(RuntimeError, match="forward-only"):
        model.hidden_states(batch["tokens"])   # the module's switch: kernels
    assert calls and calls[0] in ("ssd_chunk_tiles", "flash_attention")
