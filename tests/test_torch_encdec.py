"""The port's encoder-decoder and frontends against repro.

``repro_torch.models.frontends.apply_projector`` and the reduced
seamless-m4t-medium (``EncDec``: 2 encoder and 2 decoder layers, d 256, 8
frames of width 64) are built from the reference's parameters, carried
across by ``convert.model_from_jax``, and fed the same numpy tokens and
frames: the projector at 1e-5; the encoder's memory, prefill logits and
ten decode steps over ``encode(frames)`` at 1e-4 with equal greedy tokens;
decode against the port's own prefill at every step at 2e-3
(tests/test_models_smoke.py's contract); ``loss_fn`` at 1e-5 on the
batches ``launch.train.make_batch_fn`` draws.  A bf16 tree crosses into
the port and back bit for bit (``enc_blocks.<i>``, ``dec_blocks.<i>``,
``projector.w1``), and the vision and audio prefix batches equal
``repro.launch.train.make_batch_fn``'s bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.train import make_batch_fn as jmake_batch_fn  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import frontends as jfrontends  # noqa: E402

from repro_torch import convert, random as trandom  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import model_from_jax  # noqa: E402
from repro_torch.launch.steps import build_prefill_step, build_serve_step  # noqa: E402
from repro_torch.launch.train import make_batch_fn  # noqa: E402
from repro_torch.models import frontends  # noqa: E402

TOL = 1e-4
DECODE_TOL = 2e-3
LOSS_TOL = 1e-5
PROJ_TOL = 1e-5
B, T = 2, 10
ARCH = "seamless-m4t-medium"


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def seamless():
    """(reference model, params; port cfg, model; tokens, frames)."""
    jc, tc = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jm = jbuild_model(jc)
    params = jm.init(jax.random.key(11))
    model = model_from_jax(tc, jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, jc.vocab_size, (B, T)).astype(np.int32)
    frames = (0.1 * rng.normal(size=(B, jc.num_prefix, jc.frontend_dim))
              ).astype(np.float32)
    return jm, params, tc, model, tokens, frames


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_projector_matches_reference(dtype):
    """gelu(emb @ w1) @ w2 on float32 embeddings: with bf16 weights JAX
    promotes the products to float32, and so does the port."""
    jparams = jfrontends.init_projector(jax.random.key(2), 64, 96,
                                        jnp.dtype(dtype))
    emb = np.random.default_rng(3).normal(size=(2, 8, 64)).astype(np.float32)
    want = jfrontends.apply_projector(jparams, jnp.asarray(emb))
    tparams = {k: convert._tensor(np.asarray(v)) for k, v in jparams.items()}
    assert tparams["w1"].dtype == getattr(torch, dtype)
    got = frontends.apply_projector(tparams, torch.from_numpy(emb))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, PROJ_TOL)


def test_encode_prefill_and_decode_over_memory_match_reference(seamless):
    jm, params, tc, model, tokens, frames = seamless
    tf = torch.from_numpy(frames)
    jmem = jm.encode(params, jnp.asarray(frames))
    with torch.inference_mode():
        mem = model.encode(tf)
    _close(mem, jmem, TOL)
    want, _ = jm.prefill(params, jnp.asarray(tokens), jnp.asarray(frames))
    got, aux = build_prefill_step(model, tc, device="cpu")(
        torch.from_numpy(tokens).long(), tf)
    assert got.shape == (B, tc.padded_vocab) and float(aux) == 0.0
    _close(got, want, TOL)

    jcache = dict(jm.init_cache(B, T), memory=jmem)
    jstep = jax.jit(jm.decode_step)
    step, init_cache = build_serve_step(
        model, tc, ShapeConfig("t", T, B, "decode"), device="cpu")
    cache = init_cache()
    assert cache["memory"].shape == mem.shape and not cache["memory"].any()
    cache["memory"] = mem
    for t in range(T):
        want, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t]),
                             jnp.int32(t))
        got, cache = step(cache, torch.from_numpy(tokens[:, t]).long(), t)
        _close(got, want, TOL)
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(want).argmax(-1))


def test_decode_matches_own_prefill_at_every_step(seamless):
    """Decode logits at t over encode(frames) == the port's prefill logits
    of the length-(t+1) prompt over the same frames, at every t."""
    _, _, tc, model, tokens, frames = seamless
    tf = torch.from_numpy(frames)
    prefill = build_prefill_step(model, tc, device="cpu")
    step, init_cache = build_serve_step(
        model, tc, ShapeConfig("t", T, B, "decode"), device="cpu")
    cache = init_cache()
    with torch.inference_mode():
        cache["memory"] = model.encode(tf)
    tt = torch.from_numpy(tokens).long()
    for t in range(T):
        logits, cache = step(cache, tt[:, t], t)
        _close(logits, prefill(tt[:, :t + 1], tf)[0], DECODE_TOL)


@pytest.mark.parametrize("arch", [ARCH, "internvl2-2b"])
def test_loss_fn_on_the_train_batches_matches_reference(arch):
    """Each side's own ``make_batch_fn`` batch (equal bit for bit, below)
    through its own ``loss_fn``: the encoder-decoder over its frames, the
    vision decoder on the text positions behind its patches."""
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    jm = jbuild_model(jc)
    params = jm.init(jax.random.key(13))
    model = model_from_jax(tc, jax.tree.map(np.asarray, params), device="cpu")
    seq_len = 24
    want, wm = jm.loss_fn(params, jmake_batch_fn(jc, seq_len, B)(
        jax.random.key(4), 1))
    got, gm = model.loss_fn(make_batch_fn(tc, seq_len, B)(trandom.key(4), 1))
    _close(got.detach(), want, LOSS_TOL)
    _close(gm["xent"].detach(), wm["xent"], LOSS_TOL)
    assert float(gm["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("arch,seq_len,step", [
    ("internvl2-2b", 24, 0), ("internvl2-2b", 5, 3),
    (ARCH, 24, 0), (ARCH, 16, 2)])
def test_prefix_batches_match_reference_bitwise(arch, seq_len, step):
    """vision: the token, target and mask columns cut to [:, P:] (kept when
    seq_len <= P) and 0.02 * normal(fold_in(rng, 17)); audio: the LM batch
    and 0.02 * normal(fold_in(rng, 19)) frames."""
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    want = jmake_batch_fn(jc, seq_len, 3)(jax.random.key(7), step)
    got = make_batch_fn(tc, seq_len, 3)(trandom.key(7), step)
    assert set(got) == set(want) == {"tokens", "targets", "mask", "prefix_emb"}
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["prefix_emb"].shape == (3, tc.num_prefix, tc.frontend_dim)
    assert got["prefix_emb"].dtype == torch.float32


def test_convert_round_trip_is_bitwise_for_encdec():
    """A bf16 encoder-decoder tree crosses into the port and back bit for
    bit, dtypes kept: ``enc_blocks`` and ``dec_blocks`` split into
    ``enc_blocks.<i>`` / ``dec_blocks.<i>``, the projector nested as
    ``projector.w1`` / ``projector.w2``, the norms float32."""
    jc = dataclasses.replace(jget_config(ARCH).reduced(), dtype="bfloat16")
    tc = dataclasses.replace(get_config(ARCH).reduced(), dtype="bfloat16")
    params = jax.tree.map(np.asarray, jbuild_model(jc).init(jax.random.key(6)))
    sd = model_from_jax(tc, params, device="cpu").state_dict()
    assert sd["enc_blocks.1.attn.wq"].dtype == torch.bfloat16
    assert sd["dec_blocks.1.cross_attn.wk"].dtype == torch.bfloat16
    assert sd["dec_blocks.0.lnx"].dtype == torch.float32
    assert sd["projector.w1"].shape == (tc.frontend_dim, tc.d_model)
    assert sd["projector.w2"].dtype == torch.bfloat16
    assert sum(k.startswith("enc_blocks.") and k.endswith(".ln1")
               for k in sd) == tc.encoder_layers
    back = convert.state_dict_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for want, got in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
