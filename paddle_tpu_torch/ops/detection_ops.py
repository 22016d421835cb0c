"""Detection lowerings: the 28 ops of paddle_tpu/ops/detection_ops.py
(counterpart of that module; reference operators/detection/).

Static shapes as in the JAX package: padded outputs with label -1 in empty
slots, `GtLod` / `RowLod` lengths in place of LoD, dense [R, 4] rois with a
`RoisBatch` index vector.  The JAX package vmaps each per-image function;
here the images (and NMS's classes) are tensor dimensions, and the JAX
package's sequential loops (`_nms_single_class`'s fori_loop over candidates,
`_greedy_match`'s rounds) are Python loops over the step index whose every
step is a few batched kernels: no op on the SSD or YOLOv3 path reads a value
back to the host, so their plans replay as CUDA graphs.  Ties follow
`jnp.argsort` (stable), `argmax` and `lax.top_k` (lowest index first):
sorts are `torch.sort(..., stable=True)`, never `torch.topk`, whose order
among equal values is unspecified.  `detection_map` and
`generate_mask_labels` are host computations in the JAX package (host
callbacks) and here read their inputs to the host in process
(core/executor.py _HOST_READ)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.registry import register_op
from .common import first


def expand_aspect_ratios(input_ars, flip):
    """Dedup + flip expansion of prior_box aspect ratios (reference
    prior_box_op.h ExpandAspectRatios); shared with multi_box_head's
    prior-count computation."""
    ars = [1.0]
    for ar in input_ars:
        if any(abs(ar - a) < 1e-6 for a in ars):
            continue
        ars.append(ar)
        if flip:
            ars.append(1.0 / ar)
    return ars


def _const(ctx, op, key, build):
    """A float32 tensor made from host data once per plan (ctx.constant)."""
    return ctx.constant((op.type, id(op)) + tuple(key),
                        lambda: torch.from_numpy(build()).to(ctx.device))


def _stable_desc(s, dim=-1):
    """(values, indices) sorted descending, equal values in index order (the
    order of jnp.argsort(-s) and lax.top_k)."""
    return torch.sort(s, dim=dim, descending=True, stable=True)


def _batch_index(ins, R, device):
    bi = first(ins, "RoisBatch")
    if bi is None:
        return torch.zeros((R,), dtype=torch.int64, device=device)
    return bi.reshape(-1).long()


def _lens(ins, slot, N, B, device):
    v = first(ins, slot)
    if v is None:
        return torch.full((N,), B, dtype=torch.int64, device=device)
    return v.reshape(-1).long()


# --- anchors and priors: static, numpy once per plan ----------------------


@register_op("prior_box")
def _prior_box(ctx, op, ins):
    """reference detection/prior_box_op.h (loop at :100): SSD anchors per
    feature-map cell, from shapes and attrs alone."""
    feat = first(ins, "Input")
    image = first(ins, "Image")
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = image.shape[2], image.shape[3]
    min_sizes = list(op.attr("min_sizes"))
    max_sizes = list(op.attr("max_sizes", []) or [])
    ars = expand_aspect_ratios(list(op.attr("aspect_ratios", [1.0])), op.attr("flip", False))
    variances = list(op.attr("variances", [0.1, 0.1, 0.2, 0.2]))
    step_w = op.attr("step_w", 0.0) or IW / W
    step_h = op.attr("step_h", 0.0) or IH / H
    offset = op.attr("offset", 0.5)
    mmar_order = op.attr("min_max_aspect_ratios_order", False)

    def build():
        boxes = []
        for h in range(H):
            for w in range(W):
                cx = (w + offset) * step_w
                cy = (h + offset) * step_h
                cell = []

                def emit(bw, bh):
                    cell.append([(cx - bw) / IW, (cy - bh) / IH, (cx + bw) / IW, (cy + bh) / IH])

                for s, ms in enumerate(min_sizes):
                    if mmar_order:
                        emit(ms / 2.0, ms / 2.0)
                        if max_sizes:
                            sq = math.sqrt(ms * max_sizes[s]) / 2.0
                            emit(sq, sq)
                        for ar in ars:
                            if abs(ar - 1.0) < 1e-6:
                                continue
                            emit(ms * math.sqrt(ar) / 2.0, ms / math.sqrt(ar) / 2.0)
                    else:
                        for ar in ars:
                            emit(ms * math.sqrt(ar) / 2.0, ms / math.sqrt(ar) / 2.0)
                        if max_sizes:
                            sq = math.sqrt(ms * max_sizes[s]) / 2.0
                            emit(sq, sq)
                boxes.append(cell)
        out = np.asarray(boxes, dtype=np.float32).reshape(H, W, len(boxes[0]), 4)
        return np.clip(out, 0.0, 1.0) if op.attr("clip", False) else out

    out = _const(ctx, op, ("boxes", H, W, IH, IW), build)
    var = _const(ctx, op, ("var", H, W, IH, IW), lambda: np.tile(
        np.asarray(variances, np.float32), out.shape[:3] + (1,)))
    return {"Boxes": out, "Variances": var}


@register_op("anchor_generator")
def _anchor_generator(ctx, op, ins):
    """reference detection/anchor_generator_op.h:53-84, formula-exact."""
    feat = first(ins, "Input")
    H, W = feat.shape[2], feat.shape[3]
    sizes = list(op.attr("anchor_sizes"))
    ratios = list(op.attr("aspect_ratios"))
    variances = list(op.attr("variances", [0.1, 0.1, 0.2, 0.2]))
    stride = list(op.attr("stride"))
    offset = op.attr("offset", 0.5)
    sw, sh = float(stride[0]), float(stride[1])
    A = len(ratios) * len(sizes)

    def build():
        anchors = []
        for h in range(H):
            for w in range(W):
                x_ctr = w * sw + offset * (sw - 1)
                y_ctr = h * sh + offset * (sh - 1)
                for ar in ratios:
                    for size in sizes:
                        base_w = round(math.sqrt(sw * sh / ar))
                        base_h = round(base_w * ar)
                        aw = (size / sw) * base_w
                        ah = (size / sh) * base_h
                        anchors.append([x_ctr - 0.5 * (aw - 1), y_ctr - 0.5 * (ah - 1),
                                        x_ctr + 0.5 * (aw - 1), y_ctr + 0.5 * (ah - 1)])
        return np.asarray(anchors, np.float32).reshape(H, W, A, 4)

    return {"Anchors": _const(ctx, op, ("anchors", H, W), build),
            "Variances": _const(ctx, op, ("var", H, W), lambda: np.tile(
                np.asarray(variances, np.float32), (H, W, A, 1)))}


@register_op("density_prior_box")
def _density_prior_box(ctx, op, ins):
    """reference detection/density_prior_box_op.h: dense grids of shifted
    square priors per (fixed_size, density), corners clamped to [0, 1]."""
    feat = first(ins, "Input")
    image = first(ins, "Image")
    H, W = feat.shape[2], feat.shape[3]
    IH, IW = image.shape[2], image.shape[3]
    fixed_sizes = list(op.attr("fixed_sizes"))
    fixed_ratios = list(op.attr("fixed_ratios", [1.0]))
    densities = list(op.attr("densities"))
    variances = list(op.attr("variances", [0.1, 0.1, 0.2, 0.2]))
    step_w = op.attr("step_w", 0.0) or IW / W
    step_h = op.attr("step_h", 0.0) or IH / H
    offset = op.attr("offset", 0.5)
    if len(fixed_sizes) != len(densities):
        raise ValueError(
            f"density_prior_box: len(fixed_sizes)={len(fixed_sizes)} must "
            f"equal len(densities)={len(densities)}")
    step_average = int((step_w + step_h) * 0.5)

    def build():
        boxes = []
        for h in range(H):
            for w in range(W):
                cx = (w + offset) * step_w
                cy = (h + offset) * step_h
                cell = []
                for size, density in zip(fixed_sizes, densities):
                    shift = step_average // density
                    for ratio in fixed_ratios:
                        bw = size * math.sqrt(ratio)
                        bh = size / math.sqrt(ratio)
                        dcx = cx - step_average / 2.0 + shift / 2.0
                        dcy = cy - step_average / 2.0 + shift / 2.0
                        for di in range(density):
                            for dj in range(density):
                                ccx = dcx + dj * shift
                                ccy = dcy + di * shift
                                cell.append([max((ccx - bw / 2.0) / IW, 0.0),
                                             max((ccy - bh / 2.0) / IH, 0.0),
                                             min((ccx + bw / 2.0) / IW, 1.0),
                                             min((ccy + bh / 2.0) / IH, 1.0)])
                boxes.append(cell)
        return np.asarray(boxes, np.float32).reshape(H, W, len(boxes[0]), 4)

    out = _const(ctx, op, ("boxes", H, W, IH, IW), build)
    var = _const(ctx, op, ("var", H, W, IH, IW), lambda: np.tile(
        np.asarray(variances, np.float32), out.shape[:3] + (1,)))
    return {"Boxes": out, "Variances": var}


# --- box arithmetic --------------------------------------------------------


@register_op("iou_similarity")
def _iou_similarity(ctx, op, ins):
    """reference detection/iou_similarity_op.h: pairwise IoU [N,4]x[M,4]."""
    x = first(ins, "X")
    y = first(ins, "Y")
    one = 0.0 if op.attr("box_normalized", True) else 1.0
    ax = (x[:, 2] - x[:, 0] + one) * (x[:, 3] - x[:, 1] + one)
    ay = (y[:, 2] - y[:, 0] + one) * (y[:, 3] - y[:, 1] + one)
    lt = torch.maximum(x[:, None, :2], y[None, :, :2])
    rb = torch.minimum(x[:, None, 2:], y[None, :, 2:])
    wh = torch.clamp_min(rb - lt + one, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = ax[:, None] + ay[None, :] - inter
    return {"Out": torch.where(union > 0, inter / union, torch.zeros_like(union))}


def _decode_center_size(prior, prior_var, target, norm):
    one = 0.0 if norm else 1.0
    pw = prior[:, 2] - prior[:, 0] + one
    ph = prior[:, 3] - prior[:, 1] + one
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    tcx = target[..., 0] * prior_var[:, 0] * pw + pcx
    tcy = target[..., 1] * prior_var[:, 1] * ph + pcy
    tw = torch.exp(prior_var[:, 2] * target[..., 2]) * pw
    th = torch.exp(prior_var[:, 3] * target[..., 3]) * ph
    return torch.stack([tcx - tw / 2, tcy - th / 2, tcx + tw / 2 - one, tcy + th / 2 - one], -1)


@register_op("box_coder")
def _box_coder(ctx, op, ins):
    """reference detection/box_coder_op.h: encode/decode center-size."""
    prior = first(ins, "PriorBox")
    target = first(ins, "TargetBox")
    prior_var = first(ins, "PriorBoxVar")
    if prior_var is None:
        prior_var = torch.ones((prior.shape[0], 4), dtype=prior.dtype, device=prior.device)
    norm = op.attr("box_normalized", True)
    one = 0.0 if norm else 1.0
    if op.attr("code_type", "encode_center_size").startswith("encode"):
        pw = prior[:, 2] - prior[:, 0] + one
        ph = prior[:, 3] - prior[:, 1] + one
        pcx = prior[:, 0] + pw * 0.5
        pcy = prior[:, 1] + ph * 0.5
        tw = target[:, 2] - target[:, 0] + one
        th = target[:, 3] - target[:, 1] + one
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        dx = (tcx[:, None] - pcx[None, :]) / pw[None, :] / prior_var[None, :, 0]
        dy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / prior_var[None, :, 1]
        dw = torch.log(tw[:, None] / pw[None, :]) / prior_var[None, :, 2]
        dh = torch.log(th[:, None] / ph[None, :]) / prior_var[None, :, 3]
        return {"OutputBox": torch.stack([dx, dy, dw, dh], -1)}
    if op.attr("axis", 0) != 0 or target.dim() not in (2, 3):
        raise NotImplementedError("box_coder decode: axis=0 with 2-D or 3-D targets only")
    return {"OutputBox": _decode_center_size(prior, prior_var, target, norm)}


@register_op("box_clip")
def _box_clip(ctx, op, ins):
    """reference detection/box_clip_op.h: clip to round(im_info / scale) - 1."""
    boxes = first(ins, "Input")
    im_info = first(ins, "ImInfo")
    h = torch.round(im_info[:, 0] / im_info[:, 2]) - 1.0
    w = torch.round(im_info[:, 1] / im_info[:, 2]) - 1.0
    bshape = (-1,) + (1,) * (boxes.dim() - 2)
    w, h = w.reshape(bshape), h.reshape(bshape)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi.to(boxes.dtype))

    return {"Output": torch.stack([clip(boxes[..., 0], w), clip(boxes[..., 1], h),
                                   clip(boxes[..., 2], w), clip(boxes[..., 3], h)], -1)}


@register_op("yolo_box")
def _yolo_box(ctx, op, ins):
    """reference detection/yolo_box_op.h: decode a YOLOv3 head."""
    x = first(ins, "X")
    img_size = first(ins, "ImgSize")
    anchors = list(op.attr("anchors"))
    C = op.attr("class_num")
    conf_thresh = op.attr("conf_thresh", 0.01)
    downsample = op.attr("downsample_ratio", 32)
    A = len(anchors) // 2
    N, _, H, W = x.shape
    x = x.reshape(N, A, 5 + C, H, W)
    grid_x = torch.arange(W, device=x.device).reshape(1, 1, 1, W)
    grid_y = torch.arange(H, device=x.device).reshape(1, 1, H, 1)
    bx = (torch.sigmoid(x[:, :, 0]) + grid_x) / W
    by = (torch.sigmoid(x[:, :, 1]) + grid_y) / H
    aw = _anchor_vec(ctx, op, "aw", anchors[0::2], x).reshape(1, A, 1, 1)
    ah = _anchor_vec(ctx, op, "ah", anchors[1::2], x).reshape(1, A, 1, 1)
    bw = torch.exp(x[:, :, 2]) * aw / (downsample * W)
    bh = torch.exp(x[:, :, 3]) * ah / (downsample * H)
    conf = torch.sigmoid(x[:, :, 4])
    probs = torch.sigmoid(x[:, :, 5:]) * conf[:, :, None]
    probs = torch.where(conf[:, :, None] >= conf_thresh, probs, torch.zeros_like(probs))
    imgh = img_size[:, 0].reshape(N, 1, 1, 1).to(x.dtype)
    imgw = img_size[:, 1].reshape(N, 1, 1, 1).to(x.dtype)
    boxes = torch.stack([(bx - bw / 2) * imgw, (by - bh / 2) * imgh,
                         (bx + bw / 2) * imgw, (by + bh / 2) * imgh], -1).reshape(N, A * H * W, 4)
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, A * H * W, C)
    return {"Boxes": boxes, "Scores": scores}


def _anchor_vec(ctx, op, key, values, like):
    """A constant vector of anchor extents in like's dtype, made once per plan."""
    return ctx.constant((op.type, id(op), key, like.dtype), lambda: torch.tensor(
        values, dtype=like.dtype).to(like.device))


# --- NMS -------------------------------------------------------------------


def _nms_sorted(boxes, scores, iou_threshold, n, normalized=True):
    """Static-shape greedy NMS over the n best candidates, batched over the
    leading dims (paddle_tpu/ops/detection_ops.py _nms_single_class, vmapped
    there): boxes [..., M, 4], scores [..., M] -> (kept boxes [..., n, 4],
    their scores, -1 where empty), the kept first in score order.  The
    sequential loop runs over the candidate index; each step is a few
    kernels over all images and classes at once."""
    s, order = _stable_desc(scores)
    s, order = s[..., :n], order[..., :n]
    b = torch.gather(boxes, -2, order[..., None].expand(order.shape + (4,)))
    one = 0.0 if normalized else 1.0
    lt = torch.maximum(b[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(b[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt + one, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = torch.clamp_min((b[..., 2] - b[..., 0] + one) * (b[..., 3] - b[..., 1] + one), 0.0)
    union = area[..., :, None] + area[..., None, :] - inter
    iou = torch.where(union > 0, inter / union, torch.zeros_like(union))
    # over[..., i, j]: candidate j ranks above i and overlaps it too much
    earlier = torch.ones(n, n, dtype=torch.bool, device=b.device).tril(-1)
    over = (iou > iou_threshold) & earlier
    del iou, inter, union
    keep = torch.ones(s.shape, dtype=torch.bool, device=b.device)
    for i in range(1, n):
        keep[..., i] = ~(over[..., i, :] & keep).any(-1)
    neg = torch.full_like(s, -1.0)
    kept = torch.where(keep, s, neg)
    kept, sel = _stable_desc(kept)
    bsel = torch.gather(b, -2, sel[..., None].expand(sel.shape + (4,)))
    ssel = torch.gather(s, -1, sel)
    return bsel, torch.where(kept > 0, ssel, neg)


@register_op("multiclass_nms")
def _multiclass_nms(ctx, op, ins):
    """Static-shape multiclass NMS: each image yields a padded [keep_top_k, 6]
    block (label, score, x0, y0, x1, y1), label -1 in empty slots.  Every
    image and every kept class is one batch row of _nms_sorted."""
    bboxes = first(ins, "BBoxes")   # [N, M, 4]
    scores = first(ins, "Scores")   # [N, C, M]
    score_threshold = op.attr("score_threshold", 0.0)
    nms_top_k = op.attr("nms_top_k", 64)
    keep_top_k = op.attr("keep_top_k", 100)
    background = op.attr("background_label", 0)
    N, C, M = scores.shape
    if nms_top_k < 0:
        nms_top_k = M
    classes = [c for c in range(C) if c != background]
    if keep_top_k < 0:
        keep_top_k = len(classes) * min(nms_top_k, M)
    n = min(nms_top_k, M)
    # the kept classes by slices (an index list would be a host copy)
    sc = scores if len(classes) == C else torch.cat(
        [scores[:, :background], scores[:, background + 1:]], 1)
    s = torch.where(sc >= score_threshold, sc, torch.full_like(sc, -1.0))
    boxes = bboxes[:, None].expand(N, len(classes), M, 4)
    bb, ss = _nms_sorted(boxes, s, op.attr("nms_threshold", 0.3), n,
                         op.attr("normalized", True))
    cls = _const(ctx, op, ("classes",), lambda: np.asarray(classes, np.float32)).to(
        ss.dtype)[None, :, None]
    lab = torch.where(ss > 0, cls.expand_as(ss), torch.full_like(ss, -1.0))
    allc = torch.cat([lab[..., None], ss[..., None], bb], -1).reshape(N, -1, 6)
    _, order = _stable_desc(allc[:, :, 1])
    order = order[:, :keep_top_k]
    picked = torch.gather(allc, 1, order[..., None].expand(order.shape + (6,)))
    pad = keep_top_k - picked.shape[1]
    if pad > 0:
        picked = torch.cat([picked, picked.new_full((N, pad, 6), -1.0)], 1)
    return {"Out": picked}


# --- RoI pooling -----------------------------------------------------------


def _gather_pixels(x, bi, y, xq):
    """x[bi[r], :, y[r, p], xq[r, p]] as [R, C, P] (y, xq int64 [R, P])."""
    return x[bi[:, None], :, y, xq].permute(0, 2, 1)


@register_op("roi_align")
def _roi_align(ctx, op, ins):
    """reference detection/roi_align_op: average of bilinear samples per
    output bin; sampling_ratio <= 0 takes the JAX package's fixed 2 x 2 grid."""
    x = first(ins, "X")
    rois = first(ins, "ROIs")
    R = rois.shape[0]
    bi = _batch_index(ins, R, x.device)
    ph = op.attr("pooled_height", 1)
    pw = op.attr("pooled_width", 1)
    scale = op.attr("spatial_scale", 1.0)
    ratio = op.attr("sampling_ratio", -1)
    ns = ratio if ratio > 0 else 2
    H, W = x.shape[2], x.shape[3]
    dev = x.device
    rx0, ry0, rx1, ry1 = (rois[:, i] * scale for i in range(4))
    rw = torch.clamp_min(rx1 - rx0, 1.0)
    rh = torch.clamp_min(ry1 - ry0, 1.0)
    bin_h, bin_w = rh / ph, rw / pw
    ar = lambda n: torch.arange(n, device=dev)  # noqa: E731
    iy = (ar(ph)[None, :, None, None, None] * bin_h[:, None, None, None, None]
          + (ar(ns)[None, None, :, None, None] + 0.5) * bin_h[:, None, None, None, None] / ns
          + ry0[:, None, None, None, None])
    ix = (ar(pw)[None, None, None, :, None] * bin_w[:, None, None, None, None]
          + (ar(ns)[None, None, None, None, :] + 0.5) * bin_w[:, None, None, None, None] / ns
          + rx0[:, None, None, None, None])
    shape = (R, ph, ns, pw, ns)
    ys = iy.expand(shape).reshape(R, -1)
    xs = ix.expand(shape).reshape(R, -1)
    valid = (ys >= -1.0) & (ys <= H) & (xs >= -1.0) & (xs <= W)
    ys = torch.clamp(ys, 0.0, H - 1.0)
    xs = torch.clamp(xs, 0.0, W - 1.0)
    y0 = torch.clamp(torch.floor(ys).long(), 0, H - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[:, None]
    out = ((_gather_pixels(x, bi, y0, x0) * (1 - wx) + _gather_pixels(x, bi, y0, x1) * wx) * (1 - wy)
           + (_gather_pixels(x, bi, y1, x0) * (1 - wx) + _gather_pixels(x, bi, y1, x1) * wx) * wy)
    out = torch.where(valid[:, None], out, torch.zeros_like(out))
    out = out.reshape(R, x.shape[1], ph, ns, pw, ns).mean((3, 5))
    return {"Out": out}


@register_op("roi_pool")
def _roi_pool(ctx, op, ins):
    """reference roi_pool_op.h CPUROIPoolOpKernel: quantized-bin max pool,
    empty bins 0; Argmax the flat h * W + w of each bin's max (int32)."""
    x = first(ins, "X")
    rois = first(ins, "ROIs")
    R = rois.shape[0]
    bi = _batch_index(ins, R, x.device)
    ph = op.attr("pooled_height", 1)
    pw = op.attr("pooled_width", 1)
    scale = op.attr("spatial_scale", 1.0)
    H, W = x.shape[2], x.shape[3]
    dev = x.device
    neg = torch.finfo(torch.float32).min
    c = [torch.round(rois[:, i] * scale).to(torch.int32) for i in range(4)]
    rh = torch.clamp_min(c[3] - c[1] + 1, 1).float()
    rw = torch.clamp_min(c[2] - c[0] + 1, 1).float()
    bh, bw = rh / ph, rw / pw
    aph, apw = torch.arange(ph, device=dev), torch.arange(pw, device=dev)
    hs = torch.clamp(torch.floor(aph[None] * bh[:, None]).to(torch.int32) + c[1][:, None], 0, H)
    he = torch.clamp(torch.ceil((aph[None] + 1) * bh[:, None]).to(torch.int32) + c[1][:, None], 0, H)
    ws = torch.clamp(torch.floor(apw[None] * bw[:, None]).to(torch.int32) + c[0][:, None], 0, W)
    we = torch.clamp(torch.ceil((apw[None] + 1) * bw[:, None]).to(torch.int32) + c[0][:, None], 0, W)
    ah, aw_ = torch.arange(H, device=dev), torch.arange(W, device=dev)
    mh = (ah[None, None] >= hs[..., None]) & (ah[None, None] < he[..., None])  # [R, ph, H]
    mw = (aw_[None, None] >= ws[..., None]) & (aw_[None, None] < we[..., None])  # [R, pw, W]
    img = x[bi].float()  # [R, C, H, W]
    masked_w = torch.where(mw[:, None, None], img[:, :, :, None, :],
                           torch.full((), neg, device=dev))           # [R, C, H, pw, W]
    vw = masked_w.amax(-1)                                            # [R, C, H, pw]
    aw_i = torch.argmax(masked_w, -1)
    del masked_w
    masked_h = torch.where(mh[:, None, :, :, None], vw[:, :, None],
                           torch.full((), neg, device=dev))           # [R, C, ph, H, pw]
    out = masked_h.amax(3)                                            # [R, C, ph, pw]
    ah_i = torch.argmax(masked_h, 3)                                  # [R, C, ph, pw]
    w_best = torch.gather(aw_i, 2, ah_i)
    arg = (ah_i * W + w_best).to(torch.int32)
    empty = ((he <= hs)[:, :, None] | (we <= ws)[:, None, :])[:, None]
    zero = torch.zeros((), device=dev)
    return {"Out": torch.where(empty, zero, out).to(x.dtype),
            "Argmax": torch.where(empty, torch.zeros_like(arg), arg)}


@register_op("psroi_pool")
def _psroi_pool(ctx, op, ins):
    """Position-sensitive RoI average pool (reference psroi_pool_op.h)."""
    x = first(ins, "X")
    rois = first(ins, "ROIs").float()
    R = rois.shape[0]
    bi = _batch_index(ins, R, x.device)
    oc = op.attr("output_channels")
    ph = op.attr("pooled_height", 1)
    pw = op.attr("pooled_width", 1)
    scale = op.attr("spatial_scale", 1.0)
    N, C_in, H, W = x.shape
    dev = x.device
    v = x[bi].float().reshape(R, oc, ph, pw, H, W)
    x0 = torch.round(rois[:, 0]) * scale
    y0 = torch.round(rois[:, 1]) * scale
    x1 = (torch.round(rois[:, 2]) + 1.0) * scale
    y1 = (torch.round(rois[:, 3]) + 1.0) * scale
    bh = torch.clamp_min(y1 - y0, 0.1) / ph
    bw = torch.clamp_min(x1 - x0, 0.1) / pw
    aph, apw = torch.arange(ph, device=dev), torch.arange(pw, device=dev)
    hs = torch.clamp(torch.floor(aph[None] * bh[:, None] + y0[:, None]), 0, H)
    he = torch.clamp(torch.ceil((aph[None] + 1) * bh[:, None] + y0[:, None]), 0, H)
    ws = torch.clamp(torch.floor(apw[None] * bw[:, None] + x0[:, None]), 0, W)
    we = torch.clamp(torch.ceil((apw[None] + 1) * bw[:, None] + x0[:, None]), 0, W)
    ah, aw_ = torch.arange(H, device=dev), torch.arange(W, device=dev)
    mh = ((ah[None, None] >= hs[..., None]) & (ah[None, None] < he[..., None])).float()
    mw = ((aw_[None, None] >= ws[..., None]) & (aw_[None, None] < we[..., None])).float()
    s = torch.einsum("rcpqhw,rph,rqw->rcpq", v, mh, mw)
    area = ((he - hs)[:, :, None] * (we - ws)[:, None, :])[:, None]
    out = torch.where(area > 0, s / torch.clamp_min(area, 1.0), torch.zeros_like(s))
    return {"Out": out.to(x.dtype)}


# --- losses ----------------------------------------------------------------


@register_op("sigmoid_focal_loss")
def _sigmoid_focal_loss(ctx, op, ins):
    """reference detection/sigmoid_focal_loss_op: per-class focal loss over
    logits [N, C], labels [N, 1] in 0..C (0 background, -1 ignored), FgNum
    normalizer."""
    x = first(ins, "X")
    label = first(ins, "Label").reshape(-1)
    fg = first(ins, "FgNum")
    gamma = op.attr("gamma", 2.0)
    alpha = op.attr("alpha", 0.25)
    C = x.shape[1]
    t = (label[:, None] == (torch.arange(C, device=x.device)[None, :] + 1)).to(x.dtype)
    p = torch.sigmoid(x)
    ce = torch.clamp_min(x, 0) - x * t + torch.log1p(torch.exp(-torch.abs(x)))
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    loss = torch.where((label >= 0)[:, None], loss, torch.zeros_like(loss))
    norm = torch.clamp_min(fg.reshape(()).to(x.dtype), 1.0)
    return {"Out": loss / norm}


def _one_hot(idx, n):
    """float32 one-hot rows of idx over n classes, zero rows for ids outside
    [0, n) (jax.nn.one_hot's rule; F.one_hot would check the ids on the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _cbox_iou(x1, y1, w1, h1, x2, y2, w2, h2):
    """IoU of center-format boxes, broadcasting."""
    inter_w = torch.clamp_min(torch.minimum(x1 + w1 / 2, x2 + w2 / 2)
                              - torch.maximum(x1 - w1 / 2, x2 - w2 / 2), 0.0)
    inter_h = torch.clamp_min(torch.minimum(y1 + h1 / 2, y2 + h2 / 2)
                              - torch.maximum(y1 - h1 / 2, y2 - h2 / 2), 0.0)
    inter = inter_w * inter_h
    return inter / torch.clamp_min(w1 * h1 + w2 * h2 - inter, 1e-10)


def _sce(logit, label):
    """sigmoid cross-entropy, the reference's numerically safe form."""
    return torch.clamp_min(logit, 0.0) - logit * label + torch.log1p(torch.exp(-torch.abs(logit)))


@register_op("yolov3_loss")
def _yolov3_loss(ctx, op, ins):
    """YOLOv3 training loss (reference detection/yolov3_loss_op.h:254), the
    JAX package's vectorized form: the ignore mask and the targets are
    constants to the loss (.detach() where it stops gradients).  Two ground
    truths that match one cell write its objectness in gt order there (the
    JAX package's CPU scatter): the last one wins, resolved here by a
    comparison over gt index before a scatter whose indices are unique."""
    x = first(ins, "X").float()
    gt_box = first(ins, "GTBox").float()
    gt_label = first(ins, "GTLabel").long()
    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]
    anchors = list(op.attr("anchors"))
    anchor_mask = list(op.attr("anchor_mask"))
    C = int(op.attr("class_num"))
    ignore_thresh = float(op.attr("ignore_thresh"))
    downsample = int(op.attr("downsample_ratio"))
    smooth = op.attr("use_label_smooth", True)
    n, _, h, w = x.shape
    m = len(anchor_mask)
    an_num = len(anchors) // 2
    b = gt_box.shape[1]
    input_size = downsample * h
    dev = x.device
    gt_score = first(ins, "GTScore")
    if gt_score is not None:
        gt_score = gt_score.float()
        if gt_score.dim() == 3:
            gt_score = gt_score[..., 0]
    else:
        gt_score = torch.ones((n, b), dtype=torch.float32, device=dev)

    xr = x.reshape(n, m, 5 + C, h, w)
    tx, ty, tw, th, tobj = (xr[:, :, i] for i in range(5))
    tcls = xr[:, :, 5:]
    aw = _anchor_vec(ctx, op, "aw", [float(anchors[2 * i]) for i in anchor_mask], x)
    ah = _anchor_vec(ctx, op, "ah", [float(anchors[2 * i + 1]) for i in anchor_mask], x)
    all_w = _anchor_vec(ctx, op, "all_w", [float(a) for a in anchors[0::2]], x)
    all_h = _anchor_vec(ctx, op, "all_h", [float(a) for a in anchors[1::2]], x)
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    gx, gy, gw, gh = (gt_box[..., i] for i in range(4))
    gt_valid = (gw > 0) & (gh > 0)

    # ignore mask: constants to the loss
    px = ((grid_x + torch.sigmoid(tx)) / w).detach()
    py = ((grid_y + torch.sigmoid(ty)) / h).detach()
    pw = (torch.exp(tw) * aw[None, :, None, None] / input_size).detach()
    ph = (torch.exp(th) * ah[None, :, None, None] / input_size).detach()
    g5 = lambda t: t[:, None, None, None, :]  # noqa: E731
    iou = _cbox_iou(px[..., None], py[..., None], pw[..., None], ph[..., None],
                    g5(gx), g5(gy), g5(gw), g5(gh))
    iou = torch.where(g5(gt_valid), iou, torch.zeros_like(iou))
    best_iou = iou.amax(-1) if b > 0 else torch.zeros_like(px)
    obj_mask = torch.where(best_iou > ignore_thresh, torch.full_like(best_iou, -1.0),
                           torch.zeros_like(best_iou))

    # positive assignment per gt
    an_iou = _cbox_iou(0.0, 0.0, (all_w / input_size)[None, None, :],
                       (all_h / input_size)[None, None, :], 0.0, 0.0, gw[..., None], gh[..., None])
    best_n = torch.argmax(an_iou, -1)
    lut = [-1] * an_num
    for mi, a in enumerate(anchor_mask):
        lut[a] = mi
    mask_lut = ctx.constant((op.type, id(op), "lut"), lambda: torch.tensor(
        lut, dtype=torch.int64).to(dev))
    mask_idx = torch.where(gt_valid, mask_lut[best_n], torch.full_like(best_n, -1))
    matched = mask_idx >= 0
    gi = torch.clamp((gx * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gy * h).to(torch.int32), 0, h - 1).long()
    ni = torch.arange(n, device=dev)[:, None]
    midx = torch.clamp_min(mask_idx, 0)

    t_x = gx * w - gi
    t_y = gy * h - gj
    t_w = torch.log(torch.clamp_min(gw * input_size, 1e-9) / all_w[best_n])
    t_h = torch.log(torch.clamp_min(gh * input_size, 1e-9) / all_h[best_n])
    scale = (2.0 - gw * gh) * gt_score
    loc = (_sce(tx[ni, midx, gj, gi], t_x) + _sce(ty[ni, midx, gj, gi], t_y)
           + torch.abs(tw[ni, midx, gj, gi] - t_w) + torch.abs(th[ni, midx, gj, gi] - t_h)) * scale
    zero = torch.zeros((), device=dev)
    loc_loss = torch.where(matched, loc, zero).sum(1)

    if smooth:
        delta = min(1.0 / C, 1.0 / 40)
        pos, neg = 1.0 - delta, delta
    else:
        pos, neg = 1.0, 0.0
    p_cls = tcls[ni, midx, :, gj, gi]  # [n, b, C]
    onehot = _one_hot(gt_label, C)
    cls = _sce(p_cls, onehot * pos + (1.0 - onehot) * neg).sum(-1) * gt_score
    cls_loss = torch.where(matched, cls, zero).sum(1)

    # positive cells override ignore; of the gts matching one cell the last
    # (highest index) writes, the others go to a dummy slot that is dropped
    cell = (midx * h + gj) * w + gi
    later = torch.ones(b, b, dtype=torch.bool, device=dev).triu(1)  # [b, b']: b' > b
    beaten = ((cell[:, :, None] == cell[:, None, :]) & matched[:, None, :] & later).any(-1)
    writes = matched & ~beaten
    cell = torch.where(writes, cell, torch.full_like(cell, m * h * w))
    flat = torch.cat([obj_mask.reshape(n, -1), torch.zeros((n, 1), device=dev)], 1)
    flat = flat.scatter(1, cell, torch.where(writes, gt_score, zero.expand_as(gt_score)))
    obj_mask = flat[:, :-1].reshape(n, m, h, w).detach()
    obj_pos = torch.where(obj_mask > 1e-5, _sce(tobj, 1.0) * obj_mask, zero)
    obj_neg = torch.where((obj_mask <= 1e-5) & (obj_mask > -0.5), _sce(tobj, 0.0), zero)
    obj_loss = (obj_pos + obj_neg).sum((1, 2, 3))
    return {"Loss": loc_loss + cls_loss + obj_loss, "ObjectnessMask": obj_mask,
            "GTMatchMask": mask_idx.to(torch.int32)}


_MATCH_EPS = 1e-6


def _greedy_match(d, valid_row, match_type, thresh):
    """Matching (reference bipartite_match_op.cc), batched over images: R
    rounds of greedy global argmax, then the optional per_prediction argmax
    pass.  d [N, R, C] distances, valid_row [N, R].  Returns (col_to_row
    [N, C] int64, col_dist [N, C])."""
    N, R, C = d.shape
    dev = d.device
    col_to_row = torch.full((N, C), -1, dtype=torch.int64, device=dev)
    col_dist = torch.zeros((N, C), dtype=torch.float32, device=dev)
    row_used = torch.zeros((N, R), dtype=torch.bool, device=dev)
    base = valid_row[:, :, None] & (d >= _MATCH_EPS)
    neg = torch.full((), -1.0, device=dev)
    rows = torch.arange(R, device=dev)[None]
    cols = torch.arange(C, device=dev)[None]
    for _ in range(R):
        avail = base & ~row_used[:, :, None] & (col_to_row < 0)[:, None, :]
        cand = torch.where(avail, d, neg).reshape(N, R * C)
        flat = torch.argmax(cand, -1)
        val = torch.gather(cand, 1, flat[:, None])[:, 0]
        r, c = flat // C, flat % C
        ok = (val > 0)[:, None]
        hit_c = ok & (cols == c[:, None])
        col_to_row = torch.where(hit_c, r[:, None], col_to_row)
        col_dist = torch.where(hit_c, val[:, None], col_dist)
        row_used = row_used | (ok & (rows == r[:, None]))
    if match_type == "per_prediction":
        cand = torch.where(valid_row[:, :, None] & (d >= _MATCH_EPS) & (d >= thresh), d, neg)
        best = torch.argmax(cand, 1)
        bd = cand.amax(1)
        fresh = (col_to_row < 0) & (bd > 0)
        col_to_row = torch.where(fresh, best, col_to_row)
        col_dist = torch.where(fresh, bd, col_dist)
    return col_to_row, col_dist


@register_op("bipartite_match")
def _bipartite_match(ctx, op, ins):
    """reference detection/bipartite_match_op.cc BipartiteMatch over a dense
    DistMat [N, R, C] (+ RowLod valid-row counts)."""
    dist = first(ins, "DistMat").float()
    if dist.dim() == 2:
        dist = dist[None]
    N, R, C = dist.shape
    lens = _lens(ins, "RowLod", N, R, dist.device)
    valid = torch.arange(R, device=dist.device)[None] < lens[:, None]
    idx, dst = _greedy_match(dist, valid, op.attr("match_type", "bipartite"),
                             op.attr("dist_threshold", 0.5))
    return {"ColToRowMatchIndices": idx.to(torch.int32), "ColToRowMatchDist": dst}


@register_op("target_assign")
def _target_assign(ctx, op, ins):
    """reference detection/target_assign_op.h TargetAssignFunctor over a
    dense X [N, B, K]; NegIndices [N, Q] padded with -1."""
    x = first(ins, "X")
    match = first(ins, "MatchIndices").long()
    N, B, K = x.shape
    safe = torch.clamp(match, 0, B - 1)
    out = torch.gather(x, 1, safe[:, :, None].expand(N, match.shape[1], K))
    hit = (match >= 0)[:, :, None]
    out = torch.where(hit, out, torch.full((), op.attr("mismatch_value", 0), dtype=x.dtype,
                                           device=x.device))
    wt = hit.float()
    neg = first(ins, "NegIndices")
    if neg is not None:
        neg = neg.long()
        M = match.shape[1]
        nw = torch.zeros((N, M + 1), device=x.device)
        nw = nw.scatter(1, torch.where(neg >= 0, neg, torch.full_like(neg, M)),
                        torch.ones(neg.shape, device=x.device))
        wt = torch.maximum(wt, nw[:, :M, None])
    return {"Out": out, "OutWeight": wt}


def _corner_iou(a, b):
    """IoU of corner-format boxes a [..., M, 4] vs b [..., B, 4] -> [..., M, B]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp_min((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]), 0.0)
    area_b = torch.clamp_min((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]), 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _rank_select(cand, pri, k):
    """Select up to k True entries of `cand` along the last axis, highest
    `pri` first (ties in index order); k a number or a tensor of the
    leading shape.  Returns the selection mask and each entry's rank."""
    n = cand.shape[-1]
    key = torch.where(cand, -pri, torch.full((), float("inf"), device=pri.device))
    order = torch.sort(key, dim=-1, stable=True)[1]
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=order.device).expand_as(order))
    if torch.is_tensor(k):
        k = k[..., None]
    return cand & (rank < k), rank


def _box_to_delta(anchor, gt):
    """encode gt relative to anchor (reference bbox_util.h BoxToDelta, unit
    weights), batched over leading dims."""
    aw = anchor[..., 2] - anchor[..., 0] + 1.0
    ah = anchor[..., 3] - anchor[..., 1] + 1.0
    acx = anchor[..., 0] + aw * 0.5
    acy = anchor[..., 1] + ah * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    gcx = gt[..., 0] + gw * 0.5
    gcy = gt[..., 1] + gh * 0.5
    return torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                        torch.log(torch.clamp_min(gw, 1e-9) / aw),
                        torch.log(torch.clamp_min(gh, 1e-9) / ah)], -1)


def _gather_rows(t, idx):
    """t [N, B, ...] at idx [N, M] along axis 1."""
    return torch.gather(t, 1, idx.reshape(idx.shape + (1,) * (t.dim() - 2)).expand(
        idx.shape + t.shape[2:]))


def _best_gt(iou, gt_valid):
    """max and argmax over gts, the gts each anchor is best for."""
    a2g_max = iou.amax(-1)
    a2g_arg = torch.argmax(iou, -1)
    g_max = iou.amax(-2, keepdim=True)
    is_best = ((iou == g_max) & (g_max > 0) & gt_valid[:, None, :]).any(-1)
    return a2g_max, a2g_arg, is_best


@register_op("rpn_target_assign")
def _rpn_target_assign(ctx, op, ins):
    """RPN anchor labelling and subsampling (reference
    detection/rpn_target_assign_op.cc), static-shape: every output spans
    all anchors and the sampling lives in the weights.  Under use_random the
    priorities are drawn from the run's generator (the JAX package draws
    from its PRNG key: other numbers, the same rules)."""
    anchors = first(ins, "Anchor").float().reshape(-1, 4)
    gt = first(ins, "GtBoxes").float()
    if gt.dim() == 2:
        gt = gt[None]
    N, B, _ = gt.shape
    dev = gt.device
    lens = _lens(ins, "GtLod", N, B, dev)
    crowd = first(ins, "IsCrowd")
    crowd = (crowd.reshape(N, -1).long() if crowd is not None
             else torch.zeros((N, B), dtype=torch.int64, device=dev))
    im_info = first(ins, "ImInfo")
    im_info = (im_info.float().reshape(N, -1) if im_info is not None
               else torch.full((N, 3), float("inf"), device=dev))
    batch_size = op.attr("rpn_batch_size_per_im", 256)
    straddle = op.attr("rpn_straddle_thresh", 0.0)
    M = anchors.shape[0]
    num_fg_target = int(op.attr("rpn_fg_fraction", 0.5) * batch_size)
    h, w = im_info[:, 0:1], im_info[:, 1:2]
    if straddle >= 0:
        inside = ((anchors[None, :, 0] >= -straddle) & (anchors[None, :, 1] >= -straddle)
                  & (anchors[None, :, 2] < w + straddle) & (anchors[None, :, 3] < h + straddle))
    else:
        inside = torch.ones((N, M), dtype=torch.bool, device=dev)
    gt_valid = (torch.arange(B, device=dev)[None] < lens[:, None]) & (crowd == 0)
    iou = _corner_iou(anchors[None].expand(N, M, 4), gt)
    iou = torch.where(gt_valid[:, None, :] & inside[:, :, None], iou, torch.zeros_like(iou))
    a2g_max, a2g_arg, is_best = _best_gt(iou, gt_valid)
    fg_cand = inside & (is_best | (a2g_max >= op.attr("rpn_positive_overlap", 0.7)))
    bg_cand = inside & ~fg_cand & (a2g_max < op.attr("rpn_negative_overlap", 0.3))
    if op.attr("use_random", True):
        pri = torch.rand((N, M), generator=ctx.generator, device=dev)
    else:
        pri = a2g_max
    fg, _ = _rank_select(fg_cand, pri, num_fg_target)
    bg, _ = _rank_select(bg_cand, pri, batch_size - fg.sum(-1))
    tgt = _box_to_delta(anchors[None].expand(N, M, 4), _gather_rows(gt, a2g_arg))
    zero = torch.zeros((), device=dev)
    return {"TargetLabel": fg.to(torch.int32), "ScoreWeight": (fg | bg).float(),
            "TargetBBox": torch.where(fg[..., None], tgt, zero),
            "BBoxInsideWeight": fg[..., None].float()}


@register_op("retinanet_target_assign")
def _retinanet_target_assign(ctx, op, ins):
    """RetinaNet anchor labelling (reference retinanet_target_assign_op.cc):
    the RPN rules without subsampling, class labels, FgNum = fg count + 1."""
    anchors = first(ins, "Anchor").float().reshape(-1, 4)
    gt = first(ins, "GtBoxes").float()
    if gt.dim() == 2:
        gt = gt[None]
    N, B, _ = gt.shape
    dev = gt.device
    labels = first(ins, "GtLabels").reshape(N, -1).long()
    lens = _lens(ins, "GtLod", N, B, dev)
    crowd = first(ins, "IsCrowd")
    crowd = (crowd.reshape(N, -1).long() if crowd is not None
             else torch.zeros((N, B), dtype=torch.int64, device=dev))
    M = anchors.shape[0]
    gt_valid = (torch.arange(B, device=dev)[None] < lens[:, None]) & (crowd == 0)
    iou = _corner_iou(anchors[None].expand(N, M, 4), gt)
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))
    a2g_max, a2g_arg, is_best = _best_gt(iou, gt_valid)
    fg = is_best | (a2g_max >= op.attr("positive_overlap", 0.5))
    bg = ~fg & (a2g_max < op.attr("negative_overlap", 0.4))
    label = torch.where(fg, torch.gather(labels, 1, a2g_arg),
                        torch.where(bg, torch.zeros_like(a2g_arg), torch.full_like(a2g_arg, -1)))
    tgt = _box_to_delta(anchors[None].expand(N, M, 4), _gather_rows(gt, a2g_arg))
    zero = torch.zeros((), device=dev)
    return {"TargetLabel": label.to(torch.int32), "ScoreWeight": (fg | bg).float(),
            "TargetBBox": torch.where(fg[..., None], tgt, zero),
            "BBoxInsideWeight": fg[..., None].float(),
            "FgNum": (fg.sum(-1).to(torch.int32) + 1).reshape(N, 1)}


@register_op("generate_proposal_labels")
def _generate_proposal_labels(ctx, op, ins):
    """RCNN stage-2 RoI sampling (reference
    detection/generate_proposal_labels_op.cc), static-shape: every image
    yields batch_size_per_im rows, drawn rows packed first (fg band, then
    bg), SampleWeight 1 on drawn rows."""
    rois_in = first(ins, "RpnRois").float()
    im_info = first(ins, "ImInfo")
    if im_info is not None:
        rois_in = rois_in / im_info.float().reshape(-1, 3)[:, 2][:, None, None]
    gt_boxes = first(ins, "GtBoxes").float()
    if gt_boxes.dim() == 2:
        gt_boxes = gt_boxes[None]
    N, B = gt_boxes.shape[0], gt_boxes.shape[1]
    dev = gt_boxes.device
    gt_classes = first(ins, "GtClasses").reshape(N, -1).long()
    crowd = first(ins, "IsCrowd")
    crowd = (crowd.reshape(N, -1).long() if crowd is not None
             else torch.zeros((N, B), dtype=torch.int64, device=dev))
    lens = _lens(ins, "GtLod", N, B, dev)
    R = op.attr("batch_size_per_im", 256)
    C = op.attr("class_nums")
    P = rois_in.shape[1]
    fg_target = int(op.attr("fg_fraction", 0.25) * R)
    wvec = _const(ctx, op, ("weights",), lambda: np.asarray(
        op.attr("bbox_reg_weights", [0.1, 0.1, 0.2, 0.2]), np.float32))
    gt_valid = (torch.arange(B, device=dev)[None] < lens[:, None]) & (crowd == 0)
    cand = torch.cat([rois_in, gt_boxes], 1)  # [N, P + B, 4]
    n_cand = P + B
    iou = torch.where(gt_valid[:, None, :], _corner_iou(cand, gt_boxes), torch.zeros((), device=dev))
    max_iou = iou.amax(-1)
    argmax = torch.argmax(iou, -1)
    rows_valid = torch.cat([torch.ones((N, P), dtype=torch.bool, device=dev), gt_valid], 1)
    fg_cand = rows_valid & (max_iou >= op.attr("fg_thresh", 0.5))
    bg_cand = (rows_valid & (max_iou < op.attr("bg_thresh_hi", 0.5))
               & (max_iou >= op.attr("bg_thresh_lo", 0.0)))
    if op.attr("use_random", True):
        pri = torch.rand((N, n_cand), generator=ctx.generator, device=dev)
    else:
        pri = max_iou
    fg, rank_fg = _rank_select(fg_cand, pri, fg_target)
    bg, rank_bg = _rank_select(bg_cand, pri, R - fg.sum(-1))
    ar = torch.arange(n_cand, device=dev)[None]
    sel_rank = torch.where(fg, rank_fg, torch.where(bg, fg_target + rank_bg,
                                                    fg_target + n_cand + ar))
    order_full = torch.argsort(sel_rank, -1)
    if n_cand >= R:
        order = order_full[:, :R]
        in_pool = torch.ones((1, R), dtype=torch.bool, device=dev)
    else:
        order = torch.cat([order_full, order_full[:, -1:].expand(N, R - n_cand)], 1)
        in_pool = torch.arange(R, device=dev)[None] < n_cand
    drawn = torch.gather(fg | bg, 1, order) & in_pool
    rois = _gather_rows(cand, order)
    fg_row = torch.gather(fg, 1, order) & in_pool
    gsel = torch.gather(argmax, 1, order)
    labels = torch.where(fg_row, torch.gather(gt_classes, 1, gsel), torch.zeros_like(gsel))
    tgt = _box_to_delta(rois, _gather_rows(gt_boxes, gsel)) / wvec
    onehot = _one_hot(labels, C)  # [N, R, C]
    expanded = (onehot[..., None] * tgt[:, :, None, :]).reshape(N, R, 4 * C)
    inw = onehot.repeat_interleave(4, dim=-1) * fg_row[..., None]
    expanded = torch.where(fg_row[..., None], expanded, torch.zeros((), device=dev))
    return {"Rois": rois, "LabelsInt32": labels.to(torch.int32), "BboxTargets": expanded,
            "BboxInsideWeights": inw, "BboxOutsideWeights": inw,
            "SampleWeight": drawn.float()}


@register_op("generate_proposals")
def _generate_proposals(ctx, op, ins):
    """RPN proposal generation (reference generate_proposals_op.cc
    ProposalForOneImage): top-k by score, delta decode, clip, min-size
    filter, NMS, post_nms_topN; padded [N, post_nms_topN, 4] + probs (0 =
    empty)."""
    scores = first(ins, "Scores").float()
    deltas = first(ins, "BboxDeltas").float()
    N, A, H, W = scores.shape
    im_info = first(ins, "ImInfo").float().reshape(N, -1)
    anchors = first(ins, "Anchors").float().reshape(-1, 4)
    variances = first(ins, "Variances").float().reshape(-1, 4)
    pre_n = op.attr("pre_nms_topN", 6000)
    post_n = op.attr("post_nms_topN", 1000)
    K = A * H * W
    sc = scores.permute(0, 2, 3, 1).reshape(N, K)
    dl = deltas.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(N, K, 4)
    n_pre = min(pre_n, K)
    top_s, top_i = _stable_desc(sc)
    top_s, top_i = top_s[:, :n_pre], top_i[:, :n_pre]
    anc, var, d = anchors[top_i], variances[top_i], _gather_rows(dl, top_i)
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    acx = anc[..., 0] + aw * 0.5
    acy = anc[..., 1] + ah * 0.5
    bbox_clip = math.log(1000.0 / 16.0)
    cx = d[..., 0] * var[..., 0] * aw + acx
    cy = d[..., 1] * var[..., 1] * ah + acy
    w_ = torch.exp(torch.clamp_max(d[..., 2] * var[..., 2], bbox_clip)) * aw
    h_ = torch.exp(torch.clamp_max(d[..., 3] * var[..., 3], bbox_clip)) * ah
    ih, iw = im_info[:, 0:1], im_info[:, 1:2]
    zero = torch.zeros((), device=scores.device)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1)

    boxes = torch.stack([clip(cx - w_ / 2, iw), clip(cy - h_ / 2, ih),
                         clip(cx + w_ / 2 - 1, iw), clip(cy + h_ / 2 - 1, ih)], -1)
    ms = max(op.attr("min_size", 0.1), 1.0) * im_info[:, 2:3]
    keep = ((boxes[..., 2] - boxes[..., 0] + 1.0) >= ms) & ((boxes[..., 3] - boxes[..., 1] + 1.0) >= ms)
    s_kept = torch.where(keep, top_s, torch.full_like(top_s, -1.0))
    b, s_out = _nms_sorted(boxes, s_kept, op.attr("nms_thresh", 0.7), n_pre, normalized=False)
    return {"RpnRois": b[:, :post_n], "RpnRoiProbs": torch.clamp_min(s_out[:, :post_n], 0.0)[..., None]}


# --- SSD loss --------------------------------------------------------------


@register_op("ssd_loss")
def _ssd_loss(ctx, op, ins):
    """Fused SSD multibox loss (paddle_tpu/ops/detection_ops.py _ssd_loss):
    iou -> matching (per_prediction) -> hard-negative mining (max_negative)
    -> targets -> smooth-L1 + softmax CE, normalized by the matched count;
    the images batched.  Matching, mining and targets are constants to the
    loss (.detach(), as the JAX package's stop_gradient)."""
    loc = first(ins, "Location").float()
    conf = first(ins, "Confidence").float()
    gt_box = first(ins, "GtBox").float()
    gt_label = first(ins, "GtLabel").long()
    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]
    prior = first(ins, "PriorBox").float().reshape(-1, 4)
    pvar = first(ins, "PriorBoxVar")
    pvar = (pvar.float().reshape(-1, 4) if pvar is not None
            else torch.ones((prior.shape[0], 4), device=prior.device))
    N, B = gt_box.shape[0], gt_box.shape[1]
    P = prior.shape[0]
    dev = loc.device
    lens = _lens(ins, "GtLod", N, B, dev)
    background = op.attr("background_label", 0)
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5

    valid = torch.arange(B, device=dev)[None] < lens[:, None]
    iou = torch.where(valid[:, :, None], _corner_iou(gt_box, prior[None].expand(N, P, 4)),
                      torch.zeros((), device=dev))
    match, dist = _greedy_match(iou, valid, op.attr("match_type", "per_prediction"),
                                op.attr("overlap_threshold", 0.5))
    matched = match >= 0
    safe = torch.clamp(match, 0, B - 1)
    tgt_label = torch.where(matched, torch.gather(gt_label, 1, safe),
                            torch.full_like(safe, background))
    logp = torch.log_softmax(conf, -1)
    ce = -torch.gather(logp, 2, tgt_label[..., None])[..., 0]  # [N, P]

    cand_neg = ~matched & (dist < op.attr("neg_overlap", 0.5))
    npos = matched.sum(-1)
    n_neg = (op.attr("neg_pos_ratio", 3.0) * npos.float()).to(torch.int64)
    neg_score = torch.where(cand_neg, ce.detach(), torch.full((), -float("inf"), device=dev))
    order = _stable_desc(neg_score)[1]
    rank = torch.empty_like(order).scatter_(1, order, torch.arange(P, device=dev).expand(N, P))
    neg = cand_neg & (rank < n_neg[:, None])

    gsel = _gather_rows(gt_box, safe)
    gw = gsel[..., 2] - gsel[..., 0]
    gh = gsel[..., 3] - gsel[..., 1]
    gcx = gsel[..., 0] + gw * 0.5
    gcy = gsel[..., 1] + gh * 0.5
    enc = torch.stack([(gcx - pcx) / pw / pvar[:, 0], (gcy - pcy) / ph / pvar[:, 1],
                       torch.log(torch.clamp_min(gw, 1e-9) / pw) / pvar[:, 2],
                       torch.log(torch.clamp_min(gh, 1e-9) / ph) / pvar[:, 3]], -1)
    zero = torch.zeros((), device=dev)
    enc = torch.where(matched[..., None], enc, zero).detach()
    d = torch.where(matched[..., None], loc - enc, zero)
    ad = torch.abs(d)
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1)
    conf_loss = torch.where(matched | neg, ce, zero).sum(-1)
    losses = (op.attr("conf_loss_weight", 1.0) * conf_loss
              + op.attr("loc_loss_weight", 1.0) * sl1.sum(-1))
    if op.attr("normalize", True):
        losses = losses / torch.clamp_min(npos.sum().float(), 1.0)
    return {"Loss": losses.reshape(N, 1)}


# --- FPN and R-FCN helpers -------------------------------------------------


@register_op("distribute_fpn_proposals")
def _distribute_fpn_proposals(ctx, op, ins):
    """FPN level routing (reference distribute_fpn_proposals_op.cc) as an
    [L, R] one-hot level mask; RestoreIndex the identity."""
    rois = first(ins, "FpnRois").float().reshape(-1, 4)
    min_level = op.attr("min_level")
    max_level = op.attr("max_level")
    w = torch.clamp_min(rois[:, 2] - rois[:, 0] + 1.0, 0.0)
    h = torch.clamp_min(rois[:, 3] - rois[:, 1] + 1.0, 0.0)
    lvl = (torch.floor(torch.log2(torch.sqrt(w * h) / op.attr("refer_scale") + 1e-6))
           + op.attr("refer_level"))
    lvl = torch.clamp(lvl, min_level, max_level).long()
    mask = _one_hot(lvl - min_level, max_level - min_level + 1).T
    restore = torch.arange(rois.shape[0], dtype=torch.int32, device=rois.device)
    return {"MultiLevelMask": mask.contiguous(), "RestoreIndex": restore[:, None]}


@register_op("collect_fpn_proposals")
def _collect_fpn_proposals(ctx, op, ins):
    """reference collect_fpn_proposals_op.cc: the global top post_nms_topN
    of the concatenated per-level proposals, padded (score 0 = empty)."""
    rois = torch.cat([r if r.dim() == 3 else r[None] for r in ins["MultiLevelRois"]], 1)

    def canon(s):
        if s.dim() == 3 and s.shape[-1] == 1:
            s = s[..., 0]
        return s if s.dim() == 2 else s[None]

    scores = torch.cat([canon(s) for s in ins["MultiLevelScores"]], 1)
    post_n = op.attr("post_nms_topN")
    k = min(post_n, scores.shape[1])
    top_s, top_i = _stable_desc(scores)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    out = _gather_rows(rois, top_i)
    if k < post_n:
        out = torch.nn.functional.pad(out, (0, 0, 0, post_n - k))
        top_s = torch.nn.functional.pad(top_s, (0, post_n - k))
    return {"FpnRois": out, "RoisScores": top_s[..., None]}


@register_op("box_decoder_and_assign")
def _box_decoder_and_assign(ctx, op, ins):
    """reference box_decoder_and_assign_op.cc (R-FCN): per-class decode, then
    each roi's best non-background class's box."""
    prior = first(ins, "PriorBox").float()
    deltas = first(ins, "TargetBox").float()
    score = first(ins, "BoxScore").float()
    clip = op.attr("box_clip", float(np.log(1000.0 / 16.0)))
    R, C = prior.shape[0], score.shape[1]
    var = first(ins, "PriorBoxVar")
    if var is not None:
        var = var.float().reshape(R, 1, 4)
    else:
        var = _const(ctx, op, ("var",), lambda: np.asarray(
            op.attr("box_var", [0.1, 0.1, 0.2, 0.2]), np.float32))[None, None]
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    d = deltas.reshape(R, C, 4) * var
    cx = d[..., 0] * pw[:, None] + pcx[:, None]
    cy = d[..., 1] * ph[:, None] + pcy[:, None]
    bw = torch.exp(torch.clamp_max(d[..., 2], clip)) * pw[:, None]
    bh = torch.exp(torch.clamp_max(d[..., 3], clip)) * ph[:, None]
    decoded = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2 - 1, cy + bh / 2 - 1], -1)
    best = torch.argmax(score[:, 1:], 1) + 1
    assigned = torch.gather(decoded, 1, best[:, None, None].expand(R, 1, 4))[:, 0]
    return {"DecodeBox": decoded.reshape(R, 4 * C), "OutputAssignBox": assigned}


@register_op("polygon_box_transform")
def _polygon_box_transform(ctx, op, ins):
    """reference polygon_box_transform_op.cc (EAST): even channels
    4 * w_idx - in, odd channels 4 * h_idx - in."""
    x = first(ins, "Input")
    N, G, H, W = x.shape
    wgrid = 4.0 * torch.arange(W, dtype=torch.float32, device=x.device)[None, None, None, :]
    hgrid = 4.0 * torch.arange(H, dtype=torch.float32, device=x.device)[None, None, :, None]
    even = (torch.arange(G, device=x.device) % 2 == 0).reshape(1, G, 1, 1)
    return {"Output": torch.where(even, wgrid - x, hgrid - x)}


@register_op("roi_perspective_transform")
def _roi_perspective_transform(ctx, op, ins):
    """reference roi_perspective_transform_op.cc: each quad roi to a
    [transformed_h, transformed_w] patch by the closed-form homography;
    out-of-quad samples 0."""
    x_in = first(ins, "X")
    x = x_in.float()
    rois = first(ins, "ROIs").float()
    R = rois.shape[0]
    bi = _batch_index(ins, R, x.device)
    TH = op.attr("transformed_height")
    TW = op.attr("transformed_width")
    scale = op.attr("spatial_scale", 1.0)
    N, C, H, W = x.shape
    rx = rois[:, 0::2] * scale
    ry = rois[:, 1::2] * scale
    x0, x1, x2, x3 = (rx[:, i, None, None] for i in range(4))
    y0, y1, y2, y3 = (ry[:, i, None, None] for i in range(4))
    len1 = torch.sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
    len2 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    len3 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    len4 = torch.sqrt((x3 - x0) ** 2 + (y3 - y0) ** 2)
    est_h = (len2 + len4) / 2.0
    est_w = (len1 + len3) / 2.0
    nh = float(TH)
    nw = torch.clamp_max(torch.round(est_w * (nh - 1) / torch.clamp_min(est_h, 1e-6)) + 1, TW)
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    wm1 = torch.clamp_min(nw - 1, 1.0)
    hm1 = max(nh - 1, 1.0)
    m6 = (dx3 * dy2 - dx2 * dy3) / den / wm1
    m7 = (dx1 * dy3 - dx3 * dy1) / den / hm1
    m3 = (y1 - y0 + m6 * (nw - 1) * y1) / wm1
    m4 = (y3 - y0 + m7 * (nh - 1) * y3) / hm1
    m0 = (x1 - x0 + m6 * (nw - 1) * x1) / wm1
    m1 = (x3 - x0 + m7 * (nh - 1) * x3) / hm1
    ow = torch.arange(TW, dtype=torch.float32, device=x.device)[None, None, :]
    oh = torch.arange(TH, dtype=torch.float32, device=x.device)[None, :, None]
    denom = m6 * ow + m7 * oh + 1.0
    in_w = (m0 * ow + m1 * oh + x0) / denom
    in_h = (m3 * ow + m4 * oh + y0) / denom
    inside = ((in_w >= -0.5) & (in_w < W - 0.5) & (in_h >= -0.5) & (in_h < H - 0.5)
              & (ow < nw) & (oh < nh))
    wcl = torch.clamp(in_w, 0.0, W - 1.0)
    hcl = torch.clamp(in_h, 0.0, H - 1.0)
    yl = torch.floor(hcl).long()
    xl = torch.floor(wcl).long()
    yh = torch.clamp(yl + 1, 0, H - 1)
    xh = torch.clamp(xl + 1, 0, W - 1)
    fy = (hcl - yl)[:, None].reshape(R, 1, -1)
    fx = (wcl - xl)[:, None].reshape(R, 1, -1)
    g = lambda yy, xx: _gather_pixels(x, bi, yy.reshape(R, -1), xx.reshape(R, -1))  # noqa: E731
    v = ((g(yl, xl) * (1 - fx) + g(yl, xh) * fx) * (1 - fy)
         + (g(yh, xl) * (1 - fx) + g(yh, xh) * fx) * fy).reshape(R, C, TH, TW)
    return {"Out": torch.where(inside[:, None], v, torch.zeros((), device=x.device)).to(x_in.dtype)}


@register_op("deformable_psroi_pooling")
def _deformable_psroi_pooling(ctx, op, ins):
    """Deformable position-sensitive RoI pooling (reference
    deformable_psroi_pooling_op.h): psroi bins shifted by per-part offsets,
    each the average of its in-image clamped bilinear samples."""
    x_in = first(ins, "Input")
    x = x_in.float()
    rois = first(ins, "ROIs").float()
    trans = first(ins, "Trans")
    R = rois.shape[0]
    bi = _batch_index(ins, R, x.device)
    no_trans = op.attr("no_trans", False) or trans is None
    scale = op.attr("spatial_scale", 1.0)
    od = op.attr("output_dim")
    gh_, gw_ = op.attr("group_size", [1, 1])
    PH = op.attr("pooled_height", 1)
    PW = op.attr("pooled_width", 1)
    part_h, part_w = op.attr("part_size", [PH, PW])
    S = op.attr("sample_per_part", 1)
    trans_std = op.attr("trans_std", 0.1)
    N, C, H, W = x.shape
    dev = x.device
    ncls = 1 if no_trans else trans.shape[1] // 2
    cec = od if no_trans else od // ncls
    ph_i, pw_i = np.meshgrid(np.arange(PH), np.arange(PW), indexing="ij")
    gh_i = np.clip((ph_i * gh_ // PH), 0, gh_ - 1)
    gw_i = np.clip((pw_i * gw_ // PW), 0, gw_ - 1)
    prt_h = np.floor(ph_i / PH * part_h).astype(np.int64)
    prt_w = np.floor(pw_i / PW * part_w).astype(np.int64)
    ct = np.arange(od)
    c_idx = (ct[:, None, None] * gh_ + gh_i[None]) * gw_ + gw_i[None]  # [OD, PH, PW]
    cls_id = ct // cec
    def tens(a, key, dt=torch.float32):  # a static table, made once per plan
        return ctx.constant((op.type, id(op), key), lambda: torch.from_numpy(
            np.ascontiguousarray(a)).to(dt).to(dev))
    x0 = (torch.round(rois[:, 0]) * scale - 0.5)[:, None, None, None]
    y0 = (torch.round(rois[:, 1]) * scale - 0.5)[:, None, None, None]
    x1 = ((torch.round(rois[:, 2]) + 1.0) * scale - 0.5)[:, None, None, None]
    y1 = ((torch.round(rois[:, 3]) + 1.0) * scale - 0.5)[:, None, None, None]
    rw = torch.clamp_min(x1 - x0, 0.1)
    rh = torch.clamp_min(y1 - y0, 0.1)
    bw, bh = rw / PW, rh / PH
    sw, sh = bw / S, bh / S
    if no_trans:
        tx = ty = torch.zeros((R, od, PH, PW), device=dev)
    else:
        tr = trans.float()
        ci = tens(2 * cls_id[:, None, None] + np.zeros((1, PH, PW), np.int64), "ci", torch.int64)
        ph_t = tens(np.broadcast_to(prt_h[None], (od, PH, PW)), "ph", torch.int64)
        pw_t = tens(np.broadcast_to(prt_w[None], (od, PH, PW)), "pw", torch.int64)
        tx = tr[:, ci, ph_t, pw_t] * trans_std
        ty = tr[:, ci + 1, ph_t, pw_t] * trans_std
    wstart = tens(pw_i, "pw_i")[None, None] * bw + x0 + tx * rw  # [R, OD, PH, PW]
    hstart = tens(ph_i, "ph_i")[None, None] * bh + y0 + ty * rh
    sar = torch.arange(S, dtype=torch.float32, device=dev)
    ws = wstart[..., None, None] + sar[None, None, None, None, None, :] * sw[..., None, None]
    hs = hstart[..., None, None] + sar[None, None, None, None, :, None] * sh[..., None, None]
    ws, hs = torch.broadcast_tensors(ws, hs)  # [R, OD, PH, PW, S, S]
    valid = (ws >= -0.5) & (ws <= W - 0.5) & (hs >= -0.5) & (hs <= H - 0.5)
    wc = torch.clamp(ws, 0.0, W - 1.0)
    hc = torch.clamp(hs, 0.0, H - 1.0)
    xl = torch.floor(wc).long()
    yl = torch.floor(hc).long()
    xh = torch.clamp(xl + 1, 0, W - 1)
    yh = torch.clamp(yl + 1, 0, H - 1)
    fx = wc - xl
    fy = hc - yl
    cmap = tens(c_idx, "c_idx", torch.int64)[None, :, :, :, None, None].expand(ws.shape)
    b6 = bi[:, None, None, None, None, None].expand(ws.shape)
    v = ((x[b6, cmap, yl, xl] * (1 - fx) + x[b6, cmap, yl, xh] * fx) * (1 - fy)
         + (x[b6, cmap, yh, xl] * (1 - fx) + x[b6, cmap, yh, xh] * fx) * fy)
    v = torch.where(valid, v, torch.zeros((), device=dev))
    cnt = valid.sum((-2, -1))
    avg = torch.where(cnt > 0, v.sum((-2, -1)) / torch.clamp_min(cnt, 1), torch.zeros((), device=dev))
    return {"Output": avg.to(x_in.dtype), "TopCount": cnt.float()}


# --- host computations: read to the host in process ------------------------


def _np_detection_map(det, gt_label, gt_box, gt_difficult, gt_lens, class_num,
                      overlap_threshold, ap_type, background_label, evaluate_difficult):
    """numpy mAP (reference detection_map_op.h CalcTrueAndFalsePositive),
    the JAX package's host function."""
    aps = []
    for c in range(class_num):
        if c == background_label:
            continue
        npos = 0
        records = []
        for i in range(det.shape[0]):
            g_idx = [t for t in range(int(gt_lens[i])) if int(gt_label[i, t]) == c]
            npos += sum(1 for t in g_idx if evaluate_difficult or not gt_difficult[i, t])
            used = set()
            dets = [(float(det[i, j, 1]), det[i, j, 2:6])
                    for j in range(det.shape[1]) if int(det[i, j, 0]) == c]
            dets.sort(key=lambda r: -r[0])
            for score, box in dets:
                box = np.clip(box, 0.0, 1.0)
                best, best_t = -1.0, -1
                for t in g_idx:
                    gb = gt_box[i, t]
                    ix = max(0.0, min(box[2], gb[2]) - max(box[0], gb[0]))
                    iy = max(0.0, min(box[3], gb[3]) - max(box[1], gb[1]))
                    inter = ix * iy
                    ua = (max(box[2] - box[0], 0) * max(box[3] - box[1], 0)
                          + max(gb[2] - gb[0], 0) * max(gb[3] - gb[1], 0) - inter)
                    ov = inter / ua if ua > 0 else 0.0
                    if ov > best:
                        best, best_t = ov, t
                if best > overlap_threshold:
                    if not evaluate_difficult and gt_difficult[i, best_t]:
                        continue
                    tp = best_t not in used
                    if tp:
                        used.add(best_t)
                    records.append((score, 1.0 if tp else 0.0))
                else:
                    records.append((score, 0.0))
        if npos == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tps = np.cumsum([r[1] for r in records]) if records else np.zeros(0)
        fps = np.cumsum([1 - r[1] for r in records]) if records else np.zeros(0)
        rec = tps / npos
        prec = tps / np.maximum(tps + fps, 1e-12)
        if ap_type == "11point":
            ap = 0.0
            for th in np.arange(0.0, 1.01, 0.1):
                ap += (prec[rec >= th].max() if np.any(rec >= th) else 0.0) / 11.0
        else:
            ap = 0.0
            prev_rec = 0.0
            for k in range(len(rec)):
                ap += prec[k] * (rec[k] - prev_rec)
                prev_rec = rec[k]
        aps.append(ap)
    return np.float32(np.mean(aps) if aps else 0.0)


def _host(t):
    return t.detach().float().cpu().numpy()


@register_op("detection_map")
def _detection_map(ctx, op, ins):
    """mAP metric (reference detection_map_op.h) over DetectRes [N, D, 6]
    and Label [N, B, >= 5] (+ GtLod): the JAX package's host function on a
    host copy of the inputs (a host read: no graph captures this op)."""
    det = _host(first(ins, "DetectRes"))
    gt = _host(first(ins, "Label"))
    if gt.ndim == 2:
        gt = gt[None]
    N, B = gt.shape[0], gt.shape[1]
    lens = first(ins, "GtLod")
    lens = lens.reshape(-1).cpu().numpy() if lens is not None else np.full((N,), B)
    if gt.shape[2] >= 6:
        difficult, box = gt[:, :, 1] != 0, gt[:, :, 2:6]
    else:
        difficult, box = np.zeros(gt.shape[:2], bool), gt[:, :, 1:5]
    m = _np_detection_map(det, gt[:, :, 0], box, difficult, lens, op.attr("class_num"),
                          op.attr("overlap_threshold", 0.5), op.attr("ap_type", "integral"),
                          op.attr("background_label", 0), op.attr("evaluate_difficult", True))
    return {"MAP": torch.tensor([float(m)], dtype=torch.float32, device=ctx.device)}


def _np_rasterize_poly(poly, x0, y0, x1, y1, res):
    """Even-odd point-in-polygon over the res x res grid of the roi."""
    xs = x0 + (np.arange(res) + 0.5) * (x1 - x0) / res
    ys = y0 + (np.arange(res) + 0.5) * (y1 - y0) / res
    gx, gy = np.meshgrid(xs, ys)
    inside = np.zeros((res, res), bool)
    j = len(poly) - 1
    for i in range(len(poly)):
        xi, yi = poly[i]
        xj, yj = poly[j]
        inside ^= ((yi > gy) != (yj > gy)) & (gx < (xj - xi) * (gy - yi) / (yj - yi + 1e-12) + xi)
        j = i
    return inside.astype(np.int32)


@register_op("generate_mask_labels")
def _generate_mask_labels(ctx, op, ins):
    """Mask-RCNN mask targets (reference generate_mask_labels_op.cc) over the
    generate_proposal_labels outputs: host geometry on a host copy (a host
    read: no graph captures this op)."""
    rois_t = first(ins, "Rois")
    rois = _host(rois_t)
    labels = first(ins, "LabelsInt32").cpu().numpy().astype(np.int64)
    segms = _host(first(ins, "GtSegms"))
    N, G = segms.shape[0], segms.shape[1]
    plens = first(ins, "GtPolyLens")
    plens = plens.cpu().numpy() if plens is not None else np.full((N, G), segms.shape[2])
    glens = first(ins, "GtLod")
    glens = glens.reshape(-1).cpu().numpy() if glens is not None else np.full((N,), G)
    C = op.attr("num_classes")
    res = op.attr("resolution")
    R = rois.shape[1]
    masks = np.zeros((N, R, C * res * res), np.int32)
    has = np.zeros((N, R), np.int32)
    for i in range(N):
        polys = [segms[i, g, :int(plens[i, g])] for g in range(int(glens[i]))]
        polys = [p for p in polys if len(p) >= 3]
        if not polys:
            continue
        boxes = np.array([[p[:, 0].min(), p[:, 1].min(), p[:, 0].max(), p[:, 1].max()]
                          for p in polys])
        for r in range(R):
            lab = int(labels[i, r])
            if lab <= 0:
                continue
            bx = rois[i, r]
            ix = np.maximum(0, np.minimum(bx[2], boxes[:, 2]) - np.maximum(bx[0], boxes[:, 0]))
            iy = np.maximum(0, np.minimum(bx[3], boxes[:, 3]) - np.maximum(bx[1], boxes[:, 1]))
            inter = ix * iy
            ua = ((bx[2] - bx[0]) * (bx[3] - bx[1])
                  + (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) - inter)
            best = int(np.argmax(np.where(ua > 0, inter / np.maximum(ua, 1e-12), 0)))
            m = _np_rasterize_poly(polys[best], bx[0], bx[1], bx[2], bx[3], res)
            masks[i, r, lab * res * res:(lab + 1) * res * res] = m.reshape(-1)
            has[i, r] = 1
    dev = rois_t.device
    return {"MaskInt32": torch.from_numpy(masks).to(dev), "RoiHasMaskInt32": torch.from_numpy(has).to(dev),
            "MaskRois": rois_t.float()}
