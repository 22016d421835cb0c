"""In-program beam search lowerings (counterpart of the beam-search part of
paddle_tpu/ops/misc_ops.py): `beam_search`, `beam_search_decode` and
`key_padding_bias`.  The beam state is static [b, k] tensors carried
through a `while` (core/lowering.py), as in the JAX package."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import first
from .sequence_ops import NEG_INF_BIAS


def top_k_lower_index_first(x, k):
    """The k largest of each row of x and their indices, ties broken by the
    lower index, as jax.lax.top_k breaks them: a stable descending sort."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("beam_search")
def _beam_search(ctx, op, ins):
    """One selection step.  Logits (b*k, L, V) are the full decoder's; the
    step's row is StepIdx - 1.  Seqs (b, k, L), Scores (b, k) float32,
    Finished (b, k) bool, StepIdx (1,) int.  A finished beam extends only
    with end_id at no cost; the new token lands at column StepIdx."""
    logits = first(ins, "Logits")
    seqs = first(ins, "Seqs")
    scores = first(ins, "Scores")
    fin = first(ins, "Finished").to(torch.bool)
    t = first(ins, "StepIdx").reshape(()).long()
    k = op.attr("beam_size")
    eos = op.attr("end_id")
    b, _, L = seqs.shape
    step_logits = logits.index_select(1, (t - 1).reshape(1))[:, 0, :]
    V = step_logits.shape[-1]
    logp = torch.log_softmax(step_logits.float(), dim=-1).reshape(b, k, V)
    fin_row = torch.full((V,), NEG_INF_BIAS, dtype=torch.float32, device=logp.device)
    fin_row[eos] = 0.0
    logp = torch.where(fin[:, :, None], fin_row, logp)
    cand = scores.float()[:, :, None] + logp
    top_scores, top_idx = top_k_lower_index_first(cand.reshape(b, k * V), k)
    parent = top_idx // V
    token = (top_idx % V).to(seqs.dtype)
    new_seqs = torch.take_along_dim(seqs, parent[:, :, None], dim=1)
    col = (torch.arange(L, device=seqs.device) == t)[None, None, :]
    new_seqs = torch.where(col, token[:, :, None], new_seqs)
    new_fin = torch.take_along_dim(fin, parent, dim=1) | (token == eos)
    return {"SelectedSeqs": new_seqs, "SelectedScores": top_scores.to(scores.dtype),
            "FinishedOut": new_fin}


@register_op("beam_search_decode")
def _beam_search_decode(ctx, op, ins):
    """The best beam of each row: ids (b, L) and its score; with a
    length_penalty, scores / len^alpha first (len counts the tokens that are
    not end_id)."""
    seqs = first(ins, "Seqs")
    scores = first(ins, "Scores").float()
    lp = op.attr("length_penalty", 0.0)
    if lp:
        lengths = (seqs != op.attr("end_id")).float().sum(-1)
        scores = scores / torch.pow(lengths, lp)
    best = torch.argmax(scores, dim=1)
    ids = torch.take_along_dim(seqs, best[:, None, None], dim=1)[:, 0, :]
    return {"SentenceIds": ids,
            "SentenceScores": torch.take_along_dim(scores, best[:, None], dim=1)[:, 0]}


@register_op("key_padding_bias")
def _key_padding_bias(ctx, op, ins):
    """[b, Tk] 0/1 key mask -> additive [b, 1, 1, Tk] float32 bias: 0 where a
    key may be attended, -1e9 on padding."""
    m = first(ins, "X")
    return {"Out": ((1.0 - m.float()) * NEG_INF_BIAS)[:, None, None, :]}
