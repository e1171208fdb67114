"""The port's serving path (configs, models, steps, serve) against repro.

Reduced configs of every family the port serves — mamba2-370m (ssm, the
SSD kernels' path), yi-6b, phi3-mini and nemotron-4 (dense, the flash
kernel's path; yi-6b also with 2 kv heads of 4 so that GQA is covered,
since ``reduced()`` keeps 4 of 4), olmoe, mixtral and moonshot (MoE),
jamba (hybrid: mamba2, attention and MoE in one super-block),
seamless-m4t-medium (encoder-decoder over audio frames) and internvl2-2b
(a decoder behind vision patches) — are built by the reference, and its
parameters carried into the port with ``convert.model_from_jax``.  On
shared numpy tokens (and, for the frontend archs, shared numpy prefix
embeddings in prefill and the loss; decode takes tokens only, as the
reference's does, over the zero memory of ``init_cache``): prefill logits and
ten decode steps' logits match the reference at 1e-4, greedy tokens are
equal, the port's ``generate`` (what ``serve`` runs) yields the reference
serve loop's tokens, the port's decode reproduces its own prefill
(tests/test_models_smoke.py's contract, 2e-3, at capacity factor 8 for the
MoE configs as there), and ``loss_fn`` (cross-entropy + MoE aux) matches
the reference's at 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.launch.steps import build_serve_step as jbuild_serve_step  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.convert import model_from_jax  # noqa: E402
from repro_torch.launch.serve import generate, serve  # noqa: E402
from repro_torch.launch.steps import build_prefill_step, build_serve_step  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

TOL = 1e-4
DECODE_TOL = 2e-3
B, T = 2, 10
LOSS_TOL = 1e-5
CONFIGS = {"mamba2-370m": {}, "yi-6b": {}, "yi-6b-gqa": {"num_kv_heads": 2},
           "olmoe-1b-7b": {}, "mixtral-8x7b": {}, "moonshot-v1-16b-a3b": {},
           "jamba-v0.1-52b": {}, "phi3-mini-3.8b": {}, "nemotron-4-15b": {},
           "seamless-m4t-medium": {}, "internvl2-2b": {}}


def _configs(name):
    arch = name.removesuffix("-gqa")
    jc = dataclasses.replace(jget_config(arch).reduced(), **CONFIGS[name])
    tc = dataclasses.replace(get_config(arch).reduced(), **CONFIGS[name])
    return jc, tc


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(reference cfg, model, params; port cfg, model; tokens)."""
    jc, tc = _configs(request.param)
    jm = jbuild_model(jc)
    params = jm.init(jax.random.key(3))
    model = model_from_jax(tc, jax.tree.map(np.asarray, params), device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab_size, (B, T)).astype(np.int32)
    return jc, jm, params, tc, model, tokens


def _tt(tokens):
    return torch.from_numpy(tokens).long()


def _prefix(cfg):
    """The frontend archs' (B, num_prefix, frontend_dim) float32 patch or
    frame embeddings (tests/test_models_smoke.py's 0.1 normal), else
    None."""
    if cfg.frontend == "none":
        return None
    return (0.1 * np.random.default_rng(9).normal(
        size=(B, cfg.num_prefix, cfg.frontend_dim))).astype(np.float32)


def _jt(prefix):
    """A numpy prefix as (jax array, tensor), or (None, None)."""
    if prefix is None:
        return None, None
    return jnp.asarray(prefix), torch.from_numpy(prefix)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_configs_are_the_references(pair):
    jc, _, _, tc, _, _ = pair
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)


def test_published_configs_are_the_references():
    """Every arch the port registers, at its published size, equals the
    reference's config field for field."""
    from repro_torch.configs import ARCH_NAMES
    for arch in ARCH_NAMES:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch)), arch


def test_prefill_logits_match_reference(pair):
    jc, jm, params, tc, model, tokens = pair
    jp, tp = _jt(_prefix(tc))
    want, _ = jm.prefill(params, jnp.asarray(tokens), jp)
    got, aux = build_prefill_step(model, tc, device="cpu")(_tt(tokens), tp)
    assert got.dtype == torch.float32 and got.shape == (B, tc.padded_vocab)
    _close(got, want, TOL)


def test_decode_steps_and_greedy_tokens_match_reference(pair):
    jc, jm, params, tc, model, tokens = pair
    jcache = jm.init_cache(B, T)
    jstep = jax.jit(jm.decode_step)
    step, init_cache = build_serve_step(model, tc, ShapeConfig("t", T, B, "decode"),
                                        device="cpu")
    cache = init_cache()
    for t in range(T):
        want, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t]), jnp.int32(t))
        got, cache = step(cache, _tt(tokens[:, t]), t)
        _close(got, want, TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))


def test_generate_yields_the_reference_serve_tokens(pair):
    """The reference's serve loop (repro/launch/serve.py: prefill by
    stepping decode, then greedy) against the port's, same params and
    prompt."""
    jc, jm, params, tc, model, tokens = pair
    prompt, gen_len = 6, 5
    max_len = prompt + gen_len
    step = jbuild_serve_step(jm, jc, make_host_mesh(1),
                             JShape("serve", max_len, B, "decode"))[0]
    cache = jm.init_cache(B, max_len)
    for t in range(prompt):
        logits, cache = step(params, cache, jnp.asarray(tokens[:, t]), jnp.int32(t))
    out, cur = [], jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for t in range(prompt, max_len):
        out.append(cur)
        logits, cache = step(params, cache, cur, jnp.int32(t))
        cur = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    want = np.stack([np.asarray(x) for x in out], axis=1)
    res = generate(model, tc, _tt(tokens[:, :prompt]), gen_len, device="cpu")
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    _close(res["logits"], logits, TOL)


def test_decode_matches_own_prefill(pair):
    """tests/test_models_smoke.py:67-103 on the port: decode logits at t ==
    prefill logits of the length-(t+1) prompt.  As there, MoE configs run
    at capacity factor 8: prefill routes t + 1 tokens a row and decode one,
    so the two agree only where prefill drops nothing.  As there, the
    encoder-decoder decodes over ``encode(frames)`` and prefills over the
    same frames, and the vision decoder is held against a prefill with no
    patches (decode takes none)."""
    _, _, params, tc, model, tokens = pair
    _, frames = _jt(_prefix(tc) if tc.is_encdec else None)
    if tc.is_moe:
        tc = dataclasses.replace(tc, capacity_factor=8.0)
        model = model_from_jax(tc, jax.tree.map(np.asarray, params),
                               device="cpu")
    prefill = build_prefill_step(model, tc, device="cpu")
    step, init_cache = build_serve_step(model, tc, ShapeConfig("t", T, B, "decode"),
                                        device="cpu")
    cache = init_cache()
    if frames is not None:
        with torch.inference_mode():
            cache["memory"] = model.encode(frames)
    for t in range(T):
        logits, cache = step(cache, _tt(tokens[:, t]), t)
        if t in (3, T - 1):
            _close(logits, prefill(_tt(tokens[:, :t + 1]), frames)[0],
                   DECODE_TOL)


def test_plain_and_kernel_paths_agree(pair):
    """``use_kernels=False`` runs the plain SSD / attention of the model
    modules instead of the kernel's module: the same logits."""
    _, _, _, tc, model, tokens = pair
    _, tp = _jt(_prefix(tc))
    with torch.inference_mode():
        kern = model.prefill(_tt(tokens), tp)[0]
        model.use_kernels = False
        try:
            plain = model.prefill(_tt(tokens), tp)[0]
        finally:
            model.use_kernels = True
    _close(kern, plain, TOL)


def test_loss_fn_matches_reference(pair):
    """Next-token cross-entropy plus the MoE aux losses (0 elsewhere) of one
    batch (behind the frontend archs' prefix embeddings), on the plain
    path, against the reference's ``loss_fn``."""
    jc, jm, params, tc, model, tokens = pair
    targets = np.roll(tokens, -1, axis=1)
    mask = np.ones(tokens.shape, np.float32)
    mask[:, -1] = 0.0
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets),
              "mask": jnp.asarray(mask)}
    tbatch = {"tokens": _tt(tokens), "targets": _tt(targets),
              "mask": torch.from_numpy(mask)}
    jp, tp = _jt(_prefix(tc))
    if jp is not None:
        jbatch["prefix_emb"], tbatch["prefix_emb"] = jp, tp
    want, wm = jm.loss_fn(params, jbatch)
    got, gm = model.loss_fn(tbatch)
    _close(got.detach(), want, LOSS_TOL)
    _close(gm["aux"].detach(), wm["aux"], LOSS_TOL)
    assert (float(gm["aux"]) > 0) == tc.is_moe


@pytest.mark.parametrize("arch", ["mamba2-370m", "yi-6b", "olmoe-1b-7b",
                                  "jamba-v0.1-52b", "seamless-m4t-medium",
                                  "internvl2-2b"])
def test_serve_runs_on_cpu(arch):
    cfg = get_config(arch).reduced()
    res = serve(cfg, batch=2, prompt_len=5, gen_len=3, seed=1, device="cpu")
    assert res["tokens"].shape == (2, 3)
    assert bool(torch.isfinite(res["logits"]).all())
    again = serve(cfg, batch=2, prompt_len=5, gen_len=3, seed=1, device="cpu")
    assert torch.equal(res["tokens"], again["tokens"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    cfg = get_config("mamba2-370m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, batch=1, prompt_len=2, gen_len=1)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_prefill_step(model, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_serve_step(model, cfg, ShapeConfig("t", 4, 1, "decode"))


def test_unported_archs_and_families_raise():
    """No arch or family of the reference is left unported: the registry
    holds the reference's ten archs in its order, only a name outside them
    raises, and the encoder-decoder and frontend archs and families build
    (an ``EncDec``, a ``Transformer`` with a projector)."""
    from repro.configs import ARCH_NAMES as JARCH_NAMES
    from repro_torch.configs import ARCH_NAMES
    from repro_torch.models.encdec import EncDec
    from repro_torch.models.transformer import Transformer
    assert ARCH_NAMES == JARCH_NAMES
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    base = get_config("yi-6b").reduced()
    encdec = dataclasses.replace(base, arch_type="audio", encoder_layers=2,
                                 frontend="audio", frontend_dim=64,
                                 num_prefix=8)
    vision = dataclasses.replace(base, arch_type="vlm", frontend="vision",
                                 frontend_dim=64, num_prefix=8)
    for cfg, cls in ((get_config("seamless-m4t-medium").reduced(), EncDec),
                     (encdec, EncDec),
                     (get_config("internvl2-2b").reduced(), Transformer),
                     (vision, Transformer)):
        model = build_model(cfg, device="cpu")
        assert type(model) is cls
        assert model.state_dict()["projector.w1"].shape == (
            cfg.frontend_dim, cfg.d_model)


def test_model_from_jax_keeps_dtypes_and_splits_layers():
    """A bf16 parameter tree crosses bit for bit: matrices stay bf16, norms
    float32, and layer i of the stacked ``blocks`` becomes ``blocks.<i>``."""
    jc = dataclasses.replace(jget_config("yi-6b").reduced(), dtype="bfloat16")
    tc = dataclasses.replace(get_config("yi-6b").reduced(), dtype="bfloat16")
    params = jbuild_model(jc).init(jax.random.key(4))
    sd = model_from_jax(tc, jax.tree.map(np.asarray, params),
                        device="cpu").state_dict()
    assert sd["blocks.1.attn.wq"].dtype == torch.bfloat16
    assert sd["blocks.0.ln1"].dtype == torch.float32
    want = np.asarray(params["blocks"]["attn"]["wq"][1].astype(jnp.float32))
    np.testing.assert_array_equal(sd["blocks.1.attn.wq"].float().numpy(), want)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "olmoe-1b-7b"])
def test_convert_round_trip_is_bitwise_for_hybrid_and_moe(arch):
    """A bf16 hybrid or MoE tree crosses into the port and back bit for bit,
    dtypes kept: the hybrid's super-blocks split twice
    (``superblocks.<i>.mamba.<j>``, ``.moe.<j>``, ``.mlp.<j>``), each MoE's
    (E, d, ff) expert stacks stay one tensor and its router float32."""
    jc = dataclasses.replace(jget_config(arch).reduced(), dtype="bfloat16")
    tc = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    params = jax.tree.map(np.asarray, jbuild_model(jc).init(jax.random.key(6)))
    model = model_from_jax(tc, params, device="cpu")
    sd = model.state_dict()
    E, d, ff = tc.num_experts, tc.d_model, tc.d_ff
    if arch.startswith("jamba"):
        up, router = "superblocks.0.moe.0.w_up", "superblocks.0.moe.0.router"
        assert sd["superblocks.0.mamba.0.w_in"].dtype == torch.bfloat16
        assert sd["superblocks.0.mlp.0.w_up"].shape == (d, ff)
        assert sd["superblocks.0.ln1"].shape == (tc.attn_period, d)
    else:
        up, router = "blocks.1.moe.w_up", "blocks.1.moe.router"
    assert sd[up].shape == (E, d, ff) and sd[up].dtype == torch.bfloat16
    assert sd[router].dtype == torch.float32
    back = convert.state_dict_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for want, got in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_model_from_jax_defaults_to_cuda():
    """Conversion is an entry point like ``build_model``: without a device it
    asks for cuda, and raises on a machine without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    jc, tc = _configs("yi-6b")
    params = jax.tree.map(np.asarray, jbuild_model(jc).init(jax.random.key(4)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_from_jax(tc, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.to_torch({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.key_to_torch(np.zeros((1, 2), np.uint32))
