"""Plain-torch oracles of the port's kernels, ported from
``repro/kernels/ref.py``.

These are the semantics; the wrappers (``repro_torch.kernels.gain``,
``.flash_attention``, ``.ssd_scan``) run them for CPU tensors and
``chip_smoke.py`` holds the CUDA kernels against them on the card.  All
take leading batch dims where the reference vmaps, compute in float32 and
never use TF32.
"""

from __future__ import annotations

from typing import Optional

import torch

# Trigger modes and their ids: the port's one definition (gain_dispatch
# re-exports them, csrc/gain.cu mirrors the ids; pinned by a test).
MODES = ("theoretical", "practical", "norm", "random", "always", "never")
(MODE_THEORETICAL, MODE_PRACTICAL, MODE_NORM, MODE_RANDOM, MODE_ALWAYS,
 MODE_NEVER) = range(len(MODES))


def _full_f32():
    # the oracle is the float32 contract: no TF32 in any matmul on the card
    torch.backends.cuda.matmul.allow_tf32 = False


def gain_matvec_ref(phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """proj_t = phi_t . g: phi (..., T, n), g (..., n) -> (..., T) f32."""
    _full_f32()
    return (phi.float() @ g.float().unsqueeze(-1)).squeeze(-1)


def practical_gain_ref(phi: torch.Tensor, g: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """Eq. 15: -eps ||g||^2 + eps^2 mean_t proj_t^2, per leading index."""
    proj = gain_matvec_ref(phi, g)
    gf = g.float()
    return (-eps * (gf * gf).sum(-1)
            + eps**2 * (proj * proj).sum(-1) / phi.shape[-2])


def gain_family_stats_ref(phi: torch.Tensor, g: torch.Tensor,
                          grad_j: Optional[torch.Tensor] = None,
                          phi_matrix: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Per-agent gain-family statistics.

    phi (*B, m, T, n); g (*B, m, n); grad_j (n,) shared or (*B, n) per run;
    phi_matrix (n, n) shared or (*B, n, n) per run.  With a model returns
    (*B, m, 4) f32 ``[||g||^2, sum_t (phi_t.g)^2, g.grad_J, g^T Phi g]``;
    without one, the (*B, m, 2) prefix.
    """
    _full_f32()
    gf = g.float()
    proj = (phi.float() @ gf.unsqueeze(-1)).squeeze(-1)
    cols = [(gf * gf).sum(-1), (proj * proj).sum(-1)]
    if grad_j is not None and phi_matrix is not None:
        gj = grad_j.float()
        if gj.dim() > 1:                      # per run: broadcast over agents
            gj = gj.unsqueeze(-2)
        cols += [(gf * gj).sum(-1),
                 ((gf @ phi_matrix.float()) * gf).sum(-1)]
    return torch.stack(cols, dim=-1)


def gains_from_stats_ref(stats: torch.Tensor, mode: torch.Tensor, eps: float,
                         num_samples: int) -> torch.Tensor:
    """Mode-selected gains (eq. 13 / 15 / Remark 4) from (..., m, 2|4) stats;
    ``mode`` broadcasts against (..., m)."""
    prac = -eps * stats[..., 0] + eps**2 * stats[..., 1] / num_samples
    norm = -eps * stats[..., 0]
    theo = (-eps * stats[..., 2] + eps**2 * stats[..., 3]
            if stats.shape[-1] == 4 else prac)
    return select_gain(mode, theo, norm, prac)


def select_gain(mode: torch.Tensor, theo: torch.Tensor, norm: torch.Tensor,
                prac: torch.Tensor) -> torch.Tensor:
    """eq. 13 for "theoretical", Remark 4 for "norm", eq. 15 otherwise."""
    return torch.where(mode == MODE_THEORETICAL, theo,
                       torch.where(mode == MODE_NORM, norm, prac))


def select_alphas(mode: torch.Tensor, gate: torch.Tensor,
                  alpha_rand: torch.Tensor) -> torch.Tensor:
    """The eq. 9 gate or the random / always / never baselines, by mode."""
    one = torch.ones_like(gate)
    return torch.where(mode == MODE_ALWAYS, one,
                       torch.where(mode == MODE_NEVER, torch.zeros_like(gate),
                                   torch.where(mode == MODE_RANDOM,
                                               alpha_rand.to(gate.dtype),
                                               gate)))


def megastep_ref(phi: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                 ctl: torch.Tensor, alpha_rand: torch.Tensor,
                 grad_j: Optional[torch.Tensor] = None,
                 phi_matrix: Optional[torch.Tensor] = None,
                 deliver: Optional[torch.Tensor] = None, *,
                 eps: float):
    """Whole-inner-step oracle for R runs.

    phi (R, m, T, n); g (R, m, n); w (R, n); ctl (R, 2) f32 ``[threshold,
    mode_id]``; alpha_rand (R, m); grad_j (R, n); phi_matrix (n, n) or
    (R, n, n); deliver (R, m) optional channel keep mask.  Returns
    ``(w_next (R, n), alphas (R, m), gains (R, m))``: mode-selected gains,
    the eq. 9 trigger with its baselines, and the eq. 6 gated update over
    ``alphas * deliver``.
    """
    stats = gain_family_stats_ref(phi, g, grad_j, phi_matrix)
    thresh, mode = ctl[..., 0:1], ctl[..., 1:2]
    gains = gains_from_stats_ref(stats, mode, eps, phi.shape[-2])
    gate = (gains <= -thresh).float()
    alphas = select_alphas(mode, gate, alpha_rand.float())
    eff = alphas if deliver is None else alphas * deliver.float()
    gf = g.float()
    upd = (torch.einsum("...m,...mn->...n", eff, gf)
           / torch.clamp(eff.sum(-1, keepdim=True), min=1.0))
    return w.float() - eps * upd, alphas, gains


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Lq, H, d); k/v: (B, Lk, KVH, d) with KVH | H (GQA: query head
    h reads kv head h // (H / KVH)).  Positions are arange(L); masked
    scores take -1e30.  Returns (B, Lq, H, d) in q's dtype."""
    _full_f32()
    B, Lq, H, D = q.shape
    Lk, KVH = k.shape[1], k.shape[2]
    if KVH != H:
        k = k.repeat_interleave(H // KVH, dim=2)
        v = v.repeat_interleave(H // KVH, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D**-0.5
    qp = torch.arange(Lq, device=q.device)[:, None]
    kp = torch.arange(Lk, device=q.device)[None, :]
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def ssd_chunk_ref(dtx: torch.Tensor, cum: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor):
    """Intra-chunk SSD tiles over the full batch.

    dtx (B, nc, Q, H, P) decayed inputs; cum (B, nc, Q, H) inclusive cumsum
    of the log-decay; b/c (B, nc, Q, N), shared by the heads.  Returns
    (y_intra (B, nc, Q, H, P) in dtx's dtype, states (B, nc, H, N, P) f32):

      y[i]  = sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dtx_j
      state = sum_j exp(cum_Q - cum_j) b_j (x) dtx_j
    """
    _full_f32()
    Q = dtx.shape[2]
    x = dtx.float().permute(0, 1, 3, 2, 4)                 # (B, nc, H, Q, P)
    cm = cum.float().permute(0, 1, 3, 2)                   # (B, nc, H, Q)
    bf, cf = b.float(), c.float()
    seg = cm[..., :, None] - cm[..., None, :]              # (B, nc, H, Q, Q)
    tril = torch.ones((Q, Q), dtype=torch.bool, device=dtx.device).tril()
    decay = torch.where(tril, torch.exp(torch.where(
        tril, seg, torch.full_like(seg, -float("inf")))), torch.zeros_like(seg))
    gbc = (cf @ bf.transpose(-1, -2)).unsqueeze(2) * decay
    y = (gbc @ x).permute(0, 1, 3, 2, 4)                   # (B, nc, Q, H, P)
    w = torch.exp(cm[..., -1:] - cm)                       # (B, nc, H, Q)
    state = (bf.unsqueeze(2) * w.unsqueeze(-1)).transpose(-1, -2) @ x
    return y.to(dtx.dtype).contiguous(), state.contiguous()


def ssd_state_pass_ref(y_intra: torch.Tensor, states: torch.Tensor,
                       cum: torch.Tensor, c: torch.Tensor, length: int,
                       dtype: torch.dtype):
    """The inter-chunk pass of the chunked SSD over the full batch.

    y_intra (B, nc, Q, H, P) and states (B, nc, H, N, P) from the tile;
    cum (B, nc, Q, H); c (B, nc, Q, N).  Carries h_c = exp(cum_c,Q) h_{c-1}
    + states_c from h_{-1} = 0 and adds the inter-chunk term:

      y_c[i] = y_intra_c[i] + exp(cum_c,i) c_c,i . h_{c-1}

    Returns (y (B, length, H, P) in ``dtype``, final state (B, H, N, P)
    f32); rows past ``length`` (the pad of the last chunk) are dropped.
    """
    _full_f32()
    B, nc, Q, H, P = y_intra.shape
    cum = cum.float()
    decay = torch.exp(cum[:, :, -1, :])[..., None, None]     # (B, nc, H, 1, 1)
    h_before = torch.empty_like(states)
    h = torch.zeros_like(states[:, 0])
    for ci in range(nc):
        h_before[:, ci] = h
        h = torch.addcmul(states[:, ci], decay[:, ci], h)
    ch = torch.einsum("bcin,bchnp->bcihp", c.float(), h_before)
    y = y_intra + torch.exp(cum)[..., None] * ch
    return y.reshape(B, nc * Q, H, P)[:, :length].to(dtype), h
