"""Speculative decoding primitives: self-draft construction and the exact
rejection sampler (counterpart of midgpt_tpu/sampling/spec.py).

A cheap DRAFT model proposes k tokens autoregressively, the target scores
all k+1 positions in one batched forward (`GPT.verify_step_paged`), and a
rejection sampler accepts the longest valid prefix plus one corrected token
(Leviathan et al. 2023). The output distribution equals the target's
exactly — the draft only changes the acceptance rate:

  * token d_i (drawn from warped draft distribution q_i) is accepted with
    probability min(1, p_i[d_i] / q_i[d_i]), p_i the warped target
    distribution at that position;
  * the first rejection is replaced by a draw from norm(max(p_i - q_i, 0));
  * a fully accepted chain appends a free bonus token drawn from p_{k+1}.

Greedy (temperature 0) degenerates to argmax equality per position, which
makes speculative greedy decode token-identical to plain greedy decode. The
engine wiring (draft rounds, verify rounds, adaptive k, page-aligned
rollback) lives in sampling/serve.py. Random numbers come from an explicit
torch.Generator: a seed gives other draws than JAX's keys, so stochastic
speculation matches the JAX package in distribution only.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import torch

from midgpt_tpu_torch.models.gpt import GPTConfig, Params
from midgpt_tpu_torch.sampling.engine import warp_logits

Tensor = torch.Tensor


def self_draft(config: GPTConfig, params: Params, n_draft_layers: int) -> tp.Tuple[GPTConfig, Params]:
    """A draft model made of the first `n_draft_layers` blocks of the
    target, sharing its embedding and lm_head. `wte` and `lm_head` are the
    SAME tensors and the block leaves are views of the target's first
    layers: nothing is copied. Blocks are pre-norm residual updates, so the
    truncated stack still feeds the final norm a valid stream."""
    if not 0 < n_draft_layers < config.n_layer:
        raise ValueError(f"n_draft_layers={n_draft_layers} must be in [1, n_layer={config.n_layer})")
    draft_config = dataclasses.replace(config, n_layer=n_draft_layers)
    draft = {k: (v[:n_draft_layers] if k.startswith("blocks.") else v) for k, v in params.items()}
    return draft_config, draft


def speculative_accept(
    target_logits: Tensor,  # (B, k+1, V) — verify forward, rows 0..k
    draft_probs: Tensor,  # (B, k, V) f32 — warped draft dist of each proposal
    drafts: Tensor,  # (B, k) int — the proposed tokens
    generator: tp.Optional[torch.Generator],
    temperature: float,
    top_k: tp.Optional[int] = None,
    top_p: tp.Optional[float] = None,
) -> tp.Tuple[Tensor, Tensor]:
    """The rejection sampler (module docstring): returns (n_accept (B,)
    int32, out (B, k+1) int32). out[:, :n_accept] are the accepted drafts
    verbatim; out[:, n_accept] is the correction (on rejection) or the
    bonus token (all k accepted) — the caller emits out[:, :n_accept + 1].

    Row i of target_logits scores the position AFTER input token i (the
    verify input is [t_last, d_1, .., d_k]), so draft d_{i+1} is judged by
    row i and row k supplies the bonus distribution."""
    B, K1, _ = target_logits.shape
    K = K1 - 1
    if K < 1:
        raise ValueError("speculation needs at least one drafted token")
    tl = target_logits.float()
    drafts = drafts.long()
    rows = torch.arange(B, device=tl.device)
    if temperature == 0.0:
        tgt = torch.argmax(tl, dim=-1)  # (B, k+1) per-position greedy tokens
        acc = drafts == tgt[:, :K]
        n_accept = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        corr = tgt[rows, n_accept]
    else:
        p = torch.softmax(warp_logits(tl, temperature, top_k, top_p), dim=-1)
        p_d = torch.gather(p[:, :K], 2, drafts[..., None])[..., 0]
        q_d = torch.gather(draft_probs.float(), 2, drafts[..., None])[..., 0]
        # accept iff u < p/q, written u*q < p so q = 0 (a token the draft
        # filter zeroed) accepts whenever p > 0
        u = torch.rand((B, K), generator=generator, device=tl.device)
        acc = u * q_d < p_d
        n_accept = torch.cumprod(acc.long(), dim=1).sum(dim=1)
        p_r = p[rows, n_accept]  # (B, V)
        q_r = draft_probs.float()[rows, torch.clamp_max(n_accept, K - 1)]
        resid = torch.where((n_accept == K)[:, None], p_r, torch.clamp_min(p_r - q_r, 0.0))
        # a numerically empty residual (p <= q everywhere yet u rejected —
        # only reachable through rounding) falls back to the target row
        resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0.0, resid, p_r)
        corr = torch.multinomial(resid, 1, generator=generator)[:, 0]
    out = torch.cat([drafts, torch.zeros((B, 1), dtype=torch.long, device=tl.device)], dim=1)
    out[rows, n_accept] = corr
    return n_accept.to(torch.int32), out.to(torch.int32)
