"""The lowerings of paddle_tpu/ops/misc_ops.py: the in-program beam search
(`beam_search`, `beam_search_decode`, `key_padding_bias`; the beam state is
static [b, k] tensors carried through a `while`, core/lowering.py, as in
the JAX package), then the loss family, activations and norms, tensor
utilities, 3-D conv / pool, the spatial transforms, the sequence and
sampled classifiers, `chunk_eval` (a host read) and `hash` (XXH64)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import first, match_dtype
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


# --- the rest of paddle_tpu/ops/misc_ops.py: losses, activations and norms,
# tensor utilities, 3-D conv / pool, spatial transforms, sequence and sampled
# classifiers, the chunk metric and the hash.  Random draws come from the
# run's generator (ctx.generator); the JAX package's PRNG stream cannot be
# matched, so those ops are held to it by their moments.

@register_op("hinge_loss")
def _hinge_loss(ctx, op, ins):
    x, y = first(ins, "Logits"), first(ins, "Labels")
    return {"Loss": torch.clamp_min(1.0 - x * (2.0 * y - 1.0), 0.0)}


@register_op("log_loss")
def _log_loss(ctx, op, ins):
    p, y = first(ins, "Predicted"), first(ins, "Labels")
    eps = op.attr("epsilon", 1e-4)
    return {"Loss": -(y * torch.log(p + eps)) - (1.0 - y) * torch.log(1.0 - p + eps)}


@register_op("rank_loss")
def _rank_loss(ctx, op, ins):
    label, left, right = first(ins, "Label"), first(ins, "Left"), first(ins, "Right")
    return {"Out": torch.log(1.0 + torch.exp(left - right)) - label * (left - right)}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, op, ins):
    label, x1, x2 = first(ins, "Label"), first(ins, "X1"), first(ins, "X2")
    out = torch.clamp_min(-label * (x1 - x2) + op.attr("margin", 0.0), 0.0)
    return {"Out": out, "Activated": (out > 0).to(out.dtype)}


@register_op("bpr_loss")
def _bpr_loss(ctx, op, ins):
    """Bayesian personalized ranking: per row, the mean over the classes j
    other than the label of log(1 + exp(x_j - x_label))."""
    x, label = first(ins, "X"), first(ins, "Label")
    nclass = x.shape[-1]
    x2 = x.reshape(-1, nclass)
    lbl = label.reshape(-1).long()
    pos = torch.gather(x2, 1, lbl[:, None])
    lg = torch.log1p(torch.exp(x2 - pos))
    other = torch.arange(nclass, device=x.device)[None, :] != lbl[:, None]
    loss = torch.sum(lg * other.to(x.dtype), dim=1, keepdim=True) / (nclass - 1)
    return {"Y": loss.to(x.dtype)}


@register_op("kldiv_loss")
def _kldiv_loss(ctx, op, ins):
    x, target = first(ins, "X"), first(ins, "Target")
    red = op.attr("reduction", "mean")
    pos = target > 0
    out = torch.where(pos, target * (torch.log(torch.where(pos, target, torch.ones_like(target)))
                                     - x), torch.zeros_like(x))
    if red == "none":
        return {"Loss": out}
    if red == "batchmean":
        return {"Loss": (torch.sum(out) / x.shape[0]).reshape(())}
    if red == "sum":
        return {"Loss": torch.sum(out).reshape(())}
    return {"Loss": torch.mean(out).reshape(())}


@register_op("modified_huber_loss")
def _modified_huber_loss(ctx, op, ins):
    x, y = first(ins, "X"), first(ins, "Y")
    inter = x * (2.0 * y - 1.0)
    loss = torch.where(inter < -1.0, -4.0 * inter,
                       torch.where(inter < 1.0, torch.square(1.0 - inter), torch.zeros_like(inter)))
    return {"Out": loss, "IntermediateVal": inter}


@register_op("selu")
def _selu(ctx, op, ins):
    x = first(ins, "X")
    alpha = op.attr("alpha", 1.6732632423543772)
    scale = op.attr("scale", 1.0507009873554805)
    return {"Out": scale * torch.where(x > 0, x, alpha * torch.exp(x) - alpha)}


@register_op("lrn")
def _lrn(ctx, op, ins):
    """mid = k + alpha * the sum of x^2 over a window of n channels
    (centred, (n - 1) / 2 before), out = x mid^-beta."""
    x = first(ins, "X")
    n, k = op.attr("n", 5), op.attr("k", 2.0)
    alpha, beta = op.attr("alpha", 1e-4), op.attr("beta", 0.75)
    pre = (n - 1) // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, pre, n - 1 - pre))
    csum = F.pad(torch.cumsum(sq, dim=1), (0, 0, 0, 0, 1, 0))
    C = x.shape[1]
    mid = k + alpha * (csum[:, n:n + C] - csum[:, 0:C])
    return {"Out": x * torch.pow(mid, -beta), "MidOut": mid}


@register_op("maxout")
def _maxout(ctx, op, ins):
    x = first(ins, "X")
    g = op.attr("groups")
    N, C, H, W = x.shape
    return {"Out": x.reshape(N, C // g, g, H, W).amax(dim=2)}


@register_op("affine_channel")
def _affine_channel(ctx, op, ins):
    x = first(ins, "X")
    scale, bias = match_dtype(x, first(ins, "Scale")), match_dtype(x, first(ins, "Bias"))
    if op.attr("data_layout", "NCHW") == "NHWC":
        return {"Out": x * scale + bias}
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    return {"Out": x * scale.reshape(shape) + bias.reshape(shape)}


@register_op("multiplex")
def _multiplex(ctx, op, ins):
    xs = torch.stack(ins["X"], dim=0)  # [candidates, batch, ...]
    ids = first(ins, "Ids").reshape(-1).long()
    return {"Out": xs[ids, torch.arange(ids.shape[0], device=ids.device)]}


@register_op("reverse")
def _reverse(ctx, op, ins):
    axes = op.attr("axis")
    return {"Out": torch.flip(first(ins, "X"), [axes] if isinstance(axes, int) else list(axes))}


@register_op("diag")
def _diag(ctx, op, ins):
    return {"Out": torch.diag(first(ins, "Diagonal").reshape(-1))}


@register_op("conv3d")
def _conv3d(ctx, op, ins):
    """NCDHW activations, OIDHW filters."""
    x = first(ins, "Input")
    w = match_dtype(x, first(ins, "Filter"))
    return {"Output": F.conv3d(x, w, stride=tuple(op.attr("strides", [1, 1, 1])),
                               padding=tuple(op.attr("paddings", [0, 0, 0])),
                               dilation=tuple(op.attr("dilations", [1, 1, 1])),
                               groups=op.attr("groups", 1) or 1)}


@register_op("pool3d")
def _pool3d(ctx, op, ins):
    """Max or average pooling over NCDHW; ceil_mode pads the high side so
    the last partial window is kept, an exclusive average counts only the
    window's elements inside the input."""
    x = first(ins, "X")
    ksize = list(op.attr("ksize", [2, 2, 2]))
    strides = list(op.attr("strides", [1, 1, 1]))
    pads = list(op.attr("paddings", [0, 0, 0]))
    if op.attr("global_pooling", False):
        ksize, strides, pads = list(x.shape[2:]), [1, 1, 1], [0, 0, 0]
    hi = list(pads)
    if op.attr("ceil_mode", False):
        for i in range(3):
            rem = (x.shape[2 + i] + 2 * pads[i] - ksize[i]) % strides[i]
            if rem:
                hi[i] += strides[i] - rem
    padcfg = (pads[2], hi[2], pads[1], hi[1], pads[0], hi[0])
    if op.attr("pooling_type", "max") == "max":
        out = F.max_pool3d(F.pad(x, padcfg, value=float("-inf")), ksize, strides)
    else:
        s = F.avg_pool3d(F.pad(x, padcfg), ksize, strides, divisor_override=1)
        if op.attr("exclusive", True):
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
            out = s / F.avg_pool3d(F.pad(ones, padcfg), ksize, strides, divisor_override=1)
        else:
            out = s / float(np.prod(ksize))
    return {"Out": out.to(x.dtype)}


@register_op("affine_grid")
def _affine_grid(ctx, op, ins):
    """theta [N, 2, 3] times the base grid over [-1, 1] (corners included)
    -> the sampling grid [N, H, W, 2]."""
    theta = first(ins, "Theta")
    oshape = first(ins, "OutputShape")
    shape = oshape.tolist() if oshape is not None else op.attr("output_shape")
    h, w = int(shape[2]), int(shape[3])
    ys = torch.linspace(-1.0, 1.0, h, device=theta.device)
    xs = torch.linspace(-1.0, 1.0, w, device=theta.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1).to(theta.dtype)
    return {"Output": torch.einsum("hwk,nck->nhwc", base, theta)}


@register_op("grid_sampler")
def _grid_sampler(ctx, op, ins):
    """Bilinear samples of x [N, C, H, W] at grid [N, H', W', 2] in [-1, 1]
    scaled by (g + 1) / 2 (S - 1), zeros outside: F.grid_sample with
    align_corners and zero padding, the JAX package's convention."""
    x, grid = first(ins, "X"), first(ins, "Grid")
    return {"Output": F.grid_sample(x, match_dtype(x, grid), mode="bilinear",
                                    padding_mode="zeros", align_corners=True)}


@register_op("spectral_norm")
def _spectral_norm(ctx, op, ins):
    """W / sigma, sigma = u^T W v after power_iters steps of the power
    iteration from the inputs U and V (no gradient through u and v); U and V
    are inputs only, as in the JAX package."""
    w = first(ins, "Weight")
    u, v = first(ins, "U").reshape(-1), first(ins, "V").reshape(-1)
    dim, eps = op.attr("dim", 0), op.attr("eps", 1e-12)
    perm = (dim,) + tuple(i for i in range(w.dim()) if i != dim)
    wmat = w.permute(perm).reshape(w.shape[dim], -1)
    with torch.no_grad():
        wd = wmat.detach()
        for _ in range(op.attr("power_iters", 1)):
            v = wd.t() @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wd @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
    return {"Out": w / (u @ wmat @ v)}


@register_op("row_conv")
def _row_conv(ctx, op, ins):
    """Lookahead convolution over padded [B, T, D]: out[t] = sum_j W[j]
    x[t + j], zeros past the end."""
    x = first(ins, "X")
    w = match_dtype(x, first(ins, "Filter"))
    out = torch.zeros_like(x)
    for j in range(w.shape[0]):
        out = out + F.pad(x[:, j:, :], (0, 0, 0, j)) * w[j]
    return {"Out": out}


@register_op("im2sequence")
def _im2sequence(ctx, op, ins):
    """The kernel patches of x, row-major over the output positions, as a
    sequence [N oh ow, C kh kw] (each row C-major)."""
    x = first(ins, "X")
    kh, kw = op.attr("kernels")
    strides = op.attr("strides", [1, 1])
    pads = op.attr("paddings", [0, 0, 0, 0])  # up, left, down, right
    N, C = x.shape[0], x.shape[1]
    xp = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    cols = F.unfold(xp, (kh, kw), stride=tuple(strides))  # [N, C kh kw, oh ow]
    return {"Out": cols.transpose(1, 2).reshape(-1, C * kh * kw)}


@register_op("edit_distance")
def _edit_distance(ctx, op, ins):
    """Levenshtein distances of padded int batches [B, T] (or [B, T, 1])
    with their lengths (HypsLen, RefsLen); an empty reference gives the
    hypothesis' length; `normalized` divides by the reference's length."""
    hyp, ref = first(ins, "Hyps"), first(ins, "Refs")
    if hyp.dim() == 3 and hyp.shape[-1] == 1:
        hyp = hyp[..., 0]
    if ref.dim() == 3 and ref.shape[-1] == 1:
        ref = ref[..., 0]
    hyp_lens = first(ins, "HypsLen").reshape(-1).long()
    ref_lens = first(ins, "RefsLen").reshape(-1).long()
    B, Th, Tr = hyp.shape[0], hyp.shape[1], ref.shape[1]
    prev = torch.arange(Tr + 1, dtype=torch.float32, device=hyp.device).expand(B, Tr + 1)
    for i in range(Th):
        cost = (hyp[:, i:i + 1] != ref).float()
        cols = [torch.full((B,), i + 1.0, device=hyp.device)]
        for j in range(Tr):
            cols.append(torch.minimum(torch.minimum(prev[:, j] + cost[:, j], cols[-1] + 1.0),
                                      prev[:, j + 1] + 1.0))
        cur = torch.stack(cols, dim=1)
        prev = torch.where((i < hyp_lens)[:, None], cur, prev)
    dist = torch.gather(prev, 1, ref_lens[:, None]).reshape(-1)
    dist = torch.where(ref_lens == 0, hyp_lens.float(), dist)
    if op.attr("normalized", False):
        dist = dist / torch.clamp_min(ref_lens.float(), 1.0)
    return {"Out": dist.reshape(-1, 1),
            "SequenceNum": torch.full((1,), B, dtype=torch.int32, device=hyp.device)}


def _log_uniform(ctx, shape, classes):
    """Draws from the log-uniform distribution over [0, classes): k =
    floor(exp(u log(classes + 1)) - 1), the inverse CDF of its continuous
    approximation, as the JAX package draws them."""
    u = torch.rand(shape, generator=ctx.generator, device=ctx.device)
    k = torch.floor(torch.exp(u * np.log(classes + 1.0)) - 1.0).to(torch.int32)
    return torch.clamp(k, 0, classes - 1)


@register_op("nce")
def _nce(ctx, op, ins):
    """Noise-contrastive estimation: each row's samples are [true labels |
    negatives] (uniform, log-uniform (sampler 1), or from CustomDistProbs
    (sampler 2); custom_neg_classes fixes them); o = exp(logit), b = q num_neg,
    cost = -log(o / (o + b)) at the true columns, -log(b / (o + b)) at the
    negatives, summed over the row."""
    x = first(ins, "Input")
    w, bias = first(ins, "Weight"), first(ins, "Bias")
    sample_weight = first(ins, "SampleWeight")
    num_total = op.attr("num_total_classes")
    num_neg = op.attr("num_neg_samples", 10)
    sampler = op.attr("sampler", 0)
    custom_negs = op.attr("custom_neg_classes", None)
    B = x.shape[0]
    label = first(ins, "Label").to(torch.int32).reshape(B, -1)
    num_true = label.shape[1]
    probs = first(ins, "CustomDistProbs")
    if custom_negs:
        negs = ctx.constant(("nce_negs", tuple(custom_negs)), lambda: torch.tensor(
            custom_negs, dtype=torch.int32, device=ctx.device))[None, :].expand(B, -1)
        num_neg = len(custom_negs)
    elif sampler == 1:
        negs = _log_uniform(ctx, (B, num_neg), num_total)
    elif sampler == 2:
        cdf = torch.cumsum(torch.clamp_min(probs.float(), 1e-30), 0)
        u = torch.rand((B, num_neg), generator=ctx.generator, device=ctx.device) * cdf[-1]
        negs = torch.clamp(torch.searchsorted(cdf, u), max=probs.numel() - 1).to(torch.int32)
    else:
        negs = torch.randint(0, num_total, (B, num_neg), generator=ctx.generator,
                             device=ctx.device, dtype=torch.int32)
    samples = torch.cat([label, negs], dim=1).long()  # [B, S]
    logits = torch.einsum("bsd,bd->bs", w[samples], x)
    if bias is not None:
        logits = logits + bias.reshape(-1)[samples]
    o = torch.exp(logits)
    if sampler == 1:
        sf = samples.float()
        q = torch.log((sf + 2.0) / (sf + 1.0)) / np.log(num_total + 1.0)
    elif sampler == 2:
        q = probs.reshape(-1)[samples]
    else:
        q = torch.full(samples.shape, 1.0 / num_total, device=x.device)
    b = q * num_neg
    is_true = torch.arange(samples.shape[1], device=x.device)[None, :] < num_true
    cost = torch.where(is_true, -torch.log(o / (o + b)), -torch.log(b / (o + b)))
    total = torch.sum(cost, dim=1, keepdim=True)
    if sample_weight is not None:
        total = total * sample_weight.reshape(B, 1)
    return {"Cost": total.to(x.dtype), "SampleLogits": logits,
            "SampleLabels": samples.to(torch.int32)}


@register_op("hierarchical_sigmoid")
def _hierarchical_sigmoid(ctx, op, ins):
    """The default tree (leaf code c = label + num_classes: node (c >>
    (j + 1)) - 1, bit (c >> j) & 1 at step j) or a custom one (PathTable,
    PathCode, -1 padded); pre = clip(w_node x + b_node, -40, 40), 0 off the
    path; out = sum softplus(pre) over every column (an off-path column adds
    log 2, as in the JAX package) - sum bit pre."""
    x, w = first(ins, "X"), first(ins, "W")
    label = first(ins, "Label").reshape(-1).long()
    bias = first(ins, "Bias")
    path_table, path_code = first(ins, "PathTable"), first(ins, "PathCode")
    if path_table is not None:
        nodes = path_table.long()[label]
        bits = path_code.long()[label]
        valid = nodes >= 0
    else:
        num_classes = op.attr("num_classes")
        code_length = int(num_classes - 1).bit_length()
        c = label + num_classes
        js = torch.arange(code_length, device=x.device)
        shifted = c[:, None] >> (js[None, :] + 1)
        nodes = shifted - 1
        bits = (c[:, None] >> js[None, :]) & 1
        valid = shifted > 0
    nodes_c = torch.clamp_min(nodes, 0)
    pre = torch.einsum("bld,bd->bl", w[nodes_c], x)
    if bias is not None:
        pre = pre + bias.reshape(-1)[nodes_c]
    pre = torch.where(valid, torch.clamp(pre, -40.0, 40.0), torch.zeros_like(pre))
    out = torch.sum(torch.log1p(torch.exp(pre)), dim=1, keepdim=True) - torch.sum(
        torch.where(valid, bits.to(pre.dtype) * pre, torch.zeros_like(pre)), dim=1, keepdim=True)
    return {"Out": out.to(x.dtype), "PreOut": pre}


@register_op("ctc_greedy_decoder")
def _ctc_greedy_decoder(ctx, op, ins):
    """Argmax per step, repeats collapsed, blanks dropped: the kept tokens
    of each padded row moved to its front in order (a stable sort), zeros
    after, with their count as the output lengths."""
    x, lens = first(ins, "Input"), first(ins, "XLod")
    b, T = x.shape[0], x.shape[1]
    ids = torch.argmax(x, dim=-1).to(torch.int32)
    prev = F.pad(ids[:, :-1], (1, 0), value=-1)
    valid = torch.arange(T, device=x.device)[None, :] < lens.reshape(-1, 1)
    keep = valid & (ids != op.attr("blank", 0)) & (ids != prev)
    order = torch.sort((~keep).to(torch.int32), dim=1, stable=True)[1]
    compacted = torch.gather(ids, 1, order)
    out_lens = keep.sum(dim=1).to(torch.int32)
    pos_valid = torch.arange(T, device=x.device)[None, :] < out_lens[:, None]
    out = torch.where(pos_valid, compacted, torch.zeros_like(compacted))
    return {"Out": out[..., None], "OutLod": out_lens}


_CHUNK_SCHEMES = {
    # scheme: (num_tag_types, begin, inside, end, single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _np_chunks(labels, length, scheme, num_chunk_types, excluded):
    """The chunks (start, end, type) of one tag sequence under `scheme`
    (the reference's chunk_eval GetSegments / ChunkBegin / ChunkEnd)."""
    ntag, t_begin, t_inside, t_end, t_single = _CHUNK_SCHEMES[scheme]
    other = num_chunk_types
    segs = []
    in_chunk, start = False, 0
    tag, typ = -1, other

    def chunk_end(pt, pty, t, ty):
        if pty == other:
            return False
        if ty == other or ty != pty:
            return True
        if pt in (t_begin, t_inside) and pt >= 0:
            return t in (t_begin, t_single) and t >= 0
        if pt == t_end and pt >= 0:
            return True
        if pt == t_single and pt >= 0:
            return True
        return False

    def chunk_begin(pt, pty, t, ty):
        if pty == other:
            return ty != other
        if ty == other:
            return False
        if ty != pty:
            return True
        if t == t_begin and t >= 0:
            return True
        if t == t_inside and t >= 0:
            return pt in (t_end, t_single) and pt >= 0
        if t == t_end and t >= 0:
            return pt in (t_end, t_single) and pt >= 0
        if t == t_single and t >= 0:
            return True
        return False

    for i in range(int(length)):
        pt, pty = tag, typ
        lab = int(labels[i])
        tag = lab % ntag
        typ = lab // ntag
        if in_chunk and chunk_end(pt, pty, tag, typ):
            if pty not in excluded:
                segs.append((start, i - 1, pty))
            in_chunk = False
        if chunk_begin(pt, pty, tag, typ):
            start, in_chunk = i, True
    if in_chunk and typ not in excluded:
        segs.append((start, int(length) - 1, typ))
    return segs


@register_op("chunk_eval")
def _chunk_eval(ctx, op, ins):
    """Precision, recall and F1 of the predicted chunks against the
    labelled ones (IOB, IOE, IOBES or plain tags), over padded [b, T] tags
    and their lengths: computed on the host from host copies (a host read:
    no graph captures this op)."""
    inf, lab = first(ins, "Inference"), first(ins, "Label")
    if inf.dim() == 3:
        inf = inf[..., 0]
    if lab.dim() == 3:
        lab = lab[..., 0]
    inf_v, lab_v = inf.to(torch.int32).cpu().numpy(), lab.to(torch.int32).cpu().numpy()
    lens_v = first(ins, "XLod").reshape(-1).cpu().numpy()
    scheme, nct = op.attr("chunk_scheme", "IOB"), op.attr("num_chunk_types")
    excluded = set(op.attr("excluded_chunk_types", []) or [])
    n_inf = n_lab = n_cor = 0
    for i in range(inf_v.shape[0]):
        si = _np_chunks(inf_v[i], lens_v[i], scheme, nct, excluded)
        sl = _np_chunks(lab_v[i], lens_v[i], scheme, nct, excluded)
        n_inf, n_lab = n_inf + len(si), n_lab + len(sl)
        n_cor += len(set(si) & set(sl))
    p = n_cor / n_inf if n_inf else 0.0
    r = n_cor / n_lab if n_lab else 0.0
    f1 = 2 * p * r / (p + r) if p + r else 0.0

    def t(v, dt):
        return torch.tensor([v], dtype=dt, device=ctx.device)

    return {"Precision": t(np.float32(p), torch.float32), "Recall": t(np.float32(r), torch.float32),
            "F1-Score": t(np.float32(f1), torch.float32),
            "NumInferChunks": t(n_inf, torch.int32), "NumLabelChunks": t(n_lab, torch.int32),
            "NumCorrectChunks": t(n_cor, torch.int32)}


@register_op("sample_logits")
def _sample_logits(ctx, op, ins):
    """Sampled softmax: per row the true labels and log-uniform negatives,
    each sampled logit less log(q num_samples); a duplicate draw (and, with
    remove_accidental_hits, a draw of a true label) is masked to -1e20; the
    true labels sit at positions 0 .. num_true - 1."""
    logits = first(ins, "Logits")
    num_samples = op.attr("num_samples")
    B, C = logits.shape
    label = first(ins, "Labels").to(torch.int32).reshape(B, -1)
    num_true = label.shape[1]
    negs = _log_uniform(ctx, (B, num_samples), C)
    samples = torch.cat([label, negs], dim=1)
    sf = samples.float()
    q = torch.log((sf + 2.0) / (sf + 1.0)) / np.log(C + 1.0)
    sampled = torch.gather(logits, 1, samples.long())
    sampled = sampled - torch.log(torch.clamp_min(q * num_samples, 1e-20))
    ar = torch.arange(num_samples, device=logits.device)
    dup = (negs[:, :, None] == negs[:, None, :]) & (ar[None, :, None] > ar[None, None, :])
    drop = dup.any(-1)
    if op.attr("remove_accidental_hits", True):
        drop = drop | (negs[:, :, None] == label[:, None, :]).any(-1)
    mask = torch.cat([torch.zeros((B, num_true), dtype=torch.bool, device=logits.device), drop],
                     dim=1)
    sampled = torch.where(mask, torch.full_like(sampled, -1e20), sampled)
    pos = torch.arange(num_true, dtype=torch.int32, device=logits.device)[None, :].expand(B, -1)
    return {"SampledLogits": sampled, "SampledLabels": pos, "Samples": samples,
            "Probabilities": q}


def tree_conv_math(nodes, edges, w, max_depth):
    """Tree-based convolution of one tree: nodes [N, F]; edges [E, 2],
    1-indexed (parent, child), (0, 0) padded; w [F, 3, out, nf].  The patch
    of node u is u and its descendants at depth < max_depth, weighted by
    eta_t, eta_l, eta_r over depth, sibling index and sibling count."""
    N, E = nodes.shape[0], edges.shape[0]
    dev = nodes.device
    valid = (edges[:, 0] > 0) & (edges[:, 1] > 0)
    par = torch.where(valid, edges[:, 0], torch.zeros_like(edges[:, 0])).long()
    chd = torch.where(valid, edges[:, 1], torch.zeros_like(edges[:, 1])).long()
    node_count = valid.sum() + 1
    same = (par[None, :] == par[:, None]) & valid[None, :] & valid[:, None]
    ar = torch.arange(E, device=dev)
    index = (same & (ar[None, :] < ar[:, None])).sum(1) + 1
    pclen = same.sum(1)
    idx_of = torch.ones(N + 1, device=dev).index_put(
        (chd,), torch.where(valid, index.float(), torch.ones(E, device=dev)))[1:]
    pclen_of = torch.ones(N + 1, device=dev).index_put(
        (chd,), torch.where(valid, pclen.float(), torch.ones(E, device=dev)))[1:]
    A = torch.zeros(N + 1, N + 1, device=dev).index_put(
        (par, chd), valid.float(), accumulate=True)
    A = torch.clamp(A[1:, 1:], max=1.0)
    fd = float(max_depth)
    out3 = torch.zeros(N, N, 3, device=dev)
    diag = torch.arange(N, device=dev)
    out3[diag, diag, 2] = 1.0
    reach = A
    for d in range(1, max_depth):
        eta_t = (fd - d) / fd
        temp = torch.where(pclen_of == 1.0, torch.full_like(idx_of, 0.5),
                           (idx_of - 1.0) / torch.clamp_min(pclen_of - 1.0, 1e-12))
        eta_l = (1.0 - eta_t) * temp
        eta_r = (1.0 - eta_t) * (1.0 - eta_l)
        out3 = out3 + torch.stack([reach * eta_l[None, :], reach * eta_r[None, :],
                                   reach * eta_t], dim=-1)
        if d + 1 < max_depth:
            reach = torch.clamp(reach @ A, max=1.0)
    patch = torch.einsum("uvk,vf->ufk", out3, nodes.float()).reshape(N, -1)
    out = patch @ w.reshape(patch.shape[1], -1)
    is_node = (torch.arange(N, device=dev) < node_count)[:, None, None]
    out = out.reshape(N, w.shape[2], w.shape[3])
    return torch.where(is_node, out, torch.zeros_like(out))


@register_op("tree_conv")
def _tree_conv(ctx, op, ins):
    nodes = first(ins, "NodesVector")
    edges = first(ins, "EdgeSet").to(torch.int32)
    w = first(ins, "Filter").float()
    max_depth = op.attr("max_depth", 2)
    out = torch.stack([tree_conv_math(nodes[b], edges[b], w, max_depth)
                       for b in range(nodes.shape[0])])
    return {"Out": out.to(nodes.dtype)}


@register_op("similarity_focus")
def _similarity_focus(ctx, op, ins):
    """For each selected index on `axis`, pick the plane's largest values
    greedily, each on a row and a column no earlier pick took, and set the
    mask 1 across the whole axis at the picks."""
    x_in = first(ins, "X")
    axis = op.attr("axis")
    if axis not in (1, 2, 3):
        raise NotImplementedError("similarity_focus: axis must be 1, 2 or 3")
    perm = {1: (0, 1, 2, 3), 2: (0, 2, 1, 3), 3: (0, 3, 1, 2)}[axis]
    inv = {1: (0, 1, 2, 3), 2: (0, 2, 1, 3), 3: (0, 2, 3, 1)}[axis]
    xc = x_in.float().permute(perm)
    B, A, P, Q = xc.shape
    total = torch.zeros(B, P, Q, device=xc.device)
    rows = torch.arange(B, device=xc.device)
    for idx in op.attr("indexes"):
        plane = xc[:, idx]
        mask = torch.zeros(B, P, Q, device=xc.device)
        tag_p = torch.zeros(B, P, dtype=torch.bool, device=xc.device)
        tag_q = torch.zeros(B, Q, dtype=torch.bool, device=xc.device)
        for _ in range(min(P, Q)):
            avail = ~tag_p[:, :, None] & ~tag_q[:, None, :]
            flat = torch.argmax(torch.where(avail, plane, torch.full_like(plane, float("-inf")))
                                .reshape(B, -1), dim=1)
            p, q = flat // Q, flat % Q
            mask[rows, p, q] = 1.0
            tag_p[rows, p] = True
            tag_q[rows, q] = True
        total = torch.maximum(total, mask)
    out = total[:, None].expand(B, A, P, Q).permute(inv)
    return {"Out": out.to(x_in.dtype).contiguous()}


# XXH64 on (hi, lo) pairs of 32-bit words held in int64 tensors (torch's
# int64 shifts are arithmetic and its products overflow, so every value
# stays in [0, 2^32) and products are formed from 16-bit halves)
_M32 = 0xFFFFFFFF
_XXP1, _XXP2, _XXP3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_XXP4, _XXP5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _add64(a, b):
    lo = a[1] + b[1]
    return ((a[0] + b[0] + (lo >> 32)) & _M32, lo & _M32)


def _xor64(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _shr64(a, r):
    if r < 32:
        return (a[0] >> r, ((a[1] >> r) | (a[0] << (32 - r))) & _M32)
    return (torch.zeros_like(a[0]), a[0] >> (r - 32))


def _shl64(a, r):
    if r < 32:
        return (((a[0] << r) | (a[1] >> (32 - r))) & _M32, (a[1] << r) & _M32)
    return ((a[1] << (r - 32)) & _M32, torch.zeros_like(a[1]))


def _rot64(a, r):
    s, t = _shl64(a, r), _shr64(a, 64 - r)
    return (s[0] | t[0], s[1] | t[1])


def _mul32x32(a, b):
    """The full 64-bit product of two 32-bit words, as (hi, lo)."""
    a0, a1, b0, b1 = a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = ((mid << 16) | (p00 & 0xFFFF)) & _M32
    hi = (p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)) & _M32
    return (hi, lo)


def _mul64(a, b):
    hi, lo = _mul32x32(a[1], b[1])
    return ((hi + _mul32x32(a[1], b[0])[1] + _mul32x32(a[0], b[1])[1]) & _M32, lo)


def _c64(v, like):
    v &= 0xFFFFFFFFFFFFFFFF
    return (torch.full_like(like, v >> 32), torch.full_like(like, v & _M32))


def _xxh64_words(words, seed):
    """XXH64 of each row of `words` [rows, last] (32-bit words in int64,
    each 4 little-endian bytes of the row) under `seed`, as (hi, lo)."""
    last = words.shape[1]
    n = 4 * last
    col = words[:, 0]
    P1, P2, P3, P4, P5 = (_c64(p, col) for p in (_XXP1, _XXP2, _XXP3, _XXP4, _XXP5))

    def lane8(i):
        return (words[:, i + 1], words[:, i])

    i = 0
    if n >= 32:
        v = [_c64(seed + _XXP1 + _XXP2, col), _c64(seed + _XXP2, col), _c64(seed, col),
             _c64(seed - _XXP1, col)]
        while 4 * i + 32 <= n:
            for k in range(4):
                v[k] = _mul64(_rot64(_add64(v[k], _mul64(lane8(i + 2 * k), P2)), 31), P1)
            i += 8
        acc = _add64(_add64(_rot64(v[0], 1), _rot64(v[1], 7)),
                     _add64(_rot64(v[2], 12), _rot64(v[3], 18)))
        for vk in v:
            acc = _xor64(acc, _mul64(_rot64(_mul64(vk, P2), 31), P1))
            acc = _add64(_mul64(acc, P1), P4)
    else:
        acc = _c64(seed + _XXP5, col)
    acc = _add64(acc, _c64(n, col))
    while 4 * i + 8 <= n:
        acc = _xor64(acc, _mul64(_rot64(_mul64(lane8(i), P2), 31), P1))
        acc = _add64(_mul64(_rot64(acc, 27), P1), P4)
        i += 2
    if 4 * i + 4 <= n:
        acc = _xor64(acc, _mul64((torch.zeros_like(col), words[:, i]), P1))
        acc = _add64(_mul64(_rot64(acc, 23), P2), P3)
        i += 1
    # a row of int32 words is a multiple of 4 bytes: no 1-byte tail
    acc = _xor64(acc, _shr64(acc, 33))
    acc = _mul64(acc, P2)
    acc = _xor64(acc, _shr64(acc, 29))
    acc = _mul64(acc, P3)
    return _xor64(acc, _shr64(acc, 32))


@register_op("hash")
def _hash(ctx, op, ins):
    """Per row of int32 x, num_hash XXH64 digests of the row's bytes (seed
    = the hash's index), mod mod_by: the exact hash is the contract, since
    embedding slots depend on it."""
    x = first(ins, "X").to(torch.int32)
    mod_by, num_hash = op.attr("mod_by"), op.attr("num_hash", 1)
    words = x.reshape(-1, x.shape[-1]).to(torch.int64) & _M32
    outs = []
    for j in range(num_hash):
        hi, lo = _xxh64_words(words, j)
        outs.append(((hi * (2 ** 32 % mod_by)) % mod_by + lo % mod_by) % mod_by)
    out = torch.stack(outs, dim=-1).to(torch.int32)
    return {"Out": out.reshape(tuple(x.shape[:-1]) + (num_hash,))}
