"""Deterministic synthetic language-model batches, ported from
``repro/data/synthetic_lm.py``.

Token streams are a fixed-seed zipfian unigram draw plus positional drift,
so losses are non-degenerate and no file is read.  A batch is
``{"tokens": (B, L), "targets": (B, L), "mask": (B, L) f32}``: targets are
the tokens shifted left, the final position masked.  Tokens and targets
are int64 (torch's index dtype) holding the reference's int32 values.

The draws are the reference's ``jax.random`` calls on the port's threefry
(``repro_torch.random``), so a batch equals the reference's bit for bit:
the logs of the zipf logits and of the Gumbel noise are ``xla_log``, which
rounds as XLA's CPU code does (torch's correctly rounded ``log`` differs in
the last ulp for ~1 in 7 inputs, and one ulp can flip a Gumbel argmax).
The reference's categorical draw materialises a (B, L, V) Gumbel tensor;
here it is drawn a slice of rows at a time (``_SLICE_ELEMS`` values a
slice), which gives the same bits because threefry counters are
positional.  The multimodal prefix embeddings of the reference's
vision / audio configs are drawn where the reference draws them, in
``launch/train.py::make_batch_fn``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import random

_SLICE_ELEMS = 1 << 26   # Gumbel values drawn at once (~40 bytes each at peak)


@dataclasses.dataclass(frozen=True)
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    zipf_exponent: float = 1.1


def _zipf_logits(vocab: int, exponent: float, device=None) -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -exponent * random.xla_log(ranks)


def make_lm_batch(cfg: SyntheticLMConfig, rng: torch.Tensor,
                  step: int = 0) -> dict[str, torch.Tensor]:
    """One deterministic global batch for ``step`` on ``rng``'s device.

    ``rng`` is a key's data, (2,) int64 (``random.key(seed)``).
    """
    B, L, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    dev = rng.device
    rng = random.fold_in(rng, int(step))
    r_tok, r_shift = random.split(rng)
    logits = _zipf_logits(V, cfg.zipf_exponent, dev)
    tokens = torch.empty((B, L), dtype=torch.int64, device=dev)
    rows = max(1, _SLICE_ELEMS // (L * V))
    for r0 in range(0, B, rows):
        n = min(rows, B - r0)
        tokens[r0:r0 + n] = random.categorical(
            r_tok, logits, shape=(n, L), start=r0 * L * V, log=random.xla_log)
    # positional drift: make later positions statistically distinct so the
    # model has signal to fit (prevents trivially flat loss curves)
    drift = (torch.arange(L, dtype=torch.int64, device=dev) // 64) % 7
    tokens = (tokens + drift[None, :]) % V
    shift = random.randint(r_shift, (B, 1), 0, 7)
    tokens = (tokens + shift) % V
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = torch.ones((B, L), dtype=torch.float32, device=dev)
    mask[:, -1] = 0.0
    return {"tokens": tokens, "targets": targets, "mask": mask}
