"""Detection layers (counterpart of paddle_tpu/layers/detection.py; reference
python/paddle/fluid/layers/detection.py): the same ops, vars and attrs as
the JAX package's builders, so programs serialize identically."""
from __future__ import annotations

from ..core.layer_helper import LayerHelper


def _out(helper, dtype, shape=None):
    return helper.create_variable_for_type_inference(dtype, shape=shape)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    helper = LayerHelper("prior_box", name=name)
    boxes = _out(helper, "float32")
    variances = _out(helper, "float32")
    helper.append_op(
        "prior_box",
        inputs={"Input": [input.name], "Image": [image.name]},
        outputs={"Boxes": [boxes.name], "Variances": [variances.name]},
        attrs={"min_sizes": list(min_sizes),
               "max_sizes": list(max_sizes or []),
               "aspect_ratios": list(aspect_ratios),
               "variances": list(variance), "flip": flip, "clip": clip,
               "step_w": float(steps[0]), "step_h": float(steps[1]),
               "offset": offset,
               "min_max_aspect_ratios_order": min_max_aspect_ratios_order},
    )
    return boxes, variances


def iou_similarity(x, y, box_normalized=True, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("iou_similarity", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"box_normalized": box_normalized})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None,
              axis=0):
    helper = LayerHelper("box_coder", name=name)
    out = _out(helper, target_box.dtype)
    inputs = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op("box_coder", inputs=inputs,
                     outputs={"OutputBox": [out.name]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized, "axis": axis})
    return out


def yolo_box(x, img_size, anchors, class_num, conf_thresh=0.01,
             downsample_ratio=32, name=None):
    helper = LayerHelper("yolo_box", name=name)
    boxes = _out(helper, x.dtype)
    scores = _out(helper, x.dtype)
    helper.append_op(
        "yolo_box",
        inputs={"X": [x.name], "ImgSize": [img_size.name]},
        outputs={"Boxes": [boxes.name], "Scores": [scores.name]},
        attrs={"anchors": list(anchors), "class_num": class_num,
               "conf_thresh": conf_thresh, "downsample_ratio": downsample_ratio},
    )
    return boxes, scores


def multiclass_nms(bboxes, scores, score_threshold=0.0, nms_top_k=64,
                   keep_top_k=100, nms_threshold=0.3, normalized=True,
                   nms_eta=1.0, background_label=0, name=None):
    """Static-shape NMS: [N, keep_top_k, 6] with label -1 padding (the
    reference's LoD-shaped variable output is not a static shape)."""
    if nms_eta != 1.0:
        raise NotImplementedError("multiclass_nms: adaptive NMS (nms_eta != 1) "
                                  "is not implemented")
    helper = LayerHelper("multiclass_nms", name=name)
    out = _out(helper, bboxes.dtype)
    helper.append_op(
        "multiclass_nms",
        inputs={"BBoxes": [bboxes.name], "Scores": [scores.name]},
        outputs={"Out": [out.name]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "background_label": background_label, "normalized": normalized},
    )
    return out


def roi_align(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
              sampling_ratio=-1, rois_batch=None, name=None):
    """Static-shape RoI Align: dense [R, 4] rois + optional [R] batch index
    (replaces the reference's LoD rois)."""
    helper = LayerHelper("roi_align", name=name)
    out = _out(helper, input.dtype)
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch.name]
    helper.append_op(
        "roi_align", inputs=inputs, outputs={"Out": [out.name]},
        attrs={"pooled_height": pooled_height, "pooled_width": pooled_width,
               "spatial_scale": spatial_scale, "sampling_ratio": sampling_ratio},
    )
    return out


def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    helper = LayerHelper("sigmoid_focal_loss")
    out = _out(helper, x.dtype, shape=x.shape)
    helper.append_op(
        "sigmoid_focal_loss",
        inputs={"X": [x.name], "Label": [label.name], "FgNum": [fg_num.name]},
        outputs={"Out": [out.name]},
        attrs={"gamma": gamma, "alpha": alpha},
    )
    return out


def anchor_generator(input, anchor_sizes, aspect_ratios, stride,
                     variance=(0.1, 0.1, 0.2, 0.2), offset=0.5, name=None):
    helper = LayerHelper("anchor_generator", name=name)
    anchors = _out(helper, "float32")
    variances = _out(helper, "float32")
    helper.append_op(
        "anchor_generator", inputs={"Input": [input.name]},
        outputs={"Anchors": [anchors.name], "Variances": [variances.name]},
        attrs={"anchor_sizes": list(anchor_sizes),
               "aspect_ratios": list(aspect_ratios), "stride": list(stride),
               "variances": list(variance), "offset": offset},
    )
    return anchors, variances


def box_clip(input, im_info, name=None):
    helper = LayerHelper("box_clip", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("box_clip",
                     inputs={"Input": [input.name], "ImInfo": [im_info.name]},
                     outputs={"Output": [out.name]})
    return out


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios=(1.0,),
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, name=None):
    helper = LayerHelper("density_prior_box", name=name)
    boxes = _out(helper, "float32")
    variances = _out(helper, "float32")
    helper.append_op(
        "density_prior_box",
        inputs={"Input": [input.name], "Image": [image.name]},
        outputs={"Boxes": [boxes.name], "Variances": [variances.name]},
        attrs={"densities": list(densities), "fixed_sizes": list(fixed_sizes),
               "fixed_ratios": list(fixed_ratios), "variances": list(variance),
               "clip": clip, "step_w": float(steps[0]), "step_h": float(steps[1]),
               "offset": offset},
    )
    return boxes, variances


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True, name=None):
    """YOLOv3 loss (reference layers/detection.py:763).  gt_box [N, B, 4]
    normalized center xywh, gt_label [N, B]; returns [N] loss."""
    helper = LayerHelper("yolov3_loss", name=name)
    loss = _out(helper, x.dtype)
    obj_mask = _out(helper, x.dtype)
    match_mask = _out(helper, "int32")
    inputs = {"X": [x.name], "GTBox": [gt_box.name], "GTLabel": [gt_label.name]}
    if gt_score is not None:
        inputs["GTScore"] = [gt_score.name]
    helper.append_op(
        "yolov3_loss", inputs=inputs,
        outputs={"Loss": [loss.name], "ObjectnessMask": [obj_mask.name],
                 "GTMatchMask": [match_mask.name]},
        attrs={"anchors": list(anchors), "anchor_mask": list(anchor_mask),
               "class_num": class_num, "ignore_thresh": ignore_thresh,
               "downsample_ratio": downsample_ratio,
               "use_label_smooth": use_label_smooth},
    )
    return loss


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0,
             rois_batch=None, name=None):
    """Quantized-bin RoI max pool (reference layers/nn.py roi_pool); dense
    [R, 4] rois + optional [R] batch-index vector (static-shape form)."""
    helper = LayerHelper("roi_pool", name=name)
    out = _out(helper, input.dtype)
    argmax = _out(helper, "int64")
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch.name]
    helper.append_op(
        "roi_pool", inputs=inputs,
        outputs={"Out": [out.name], "Argmax": [argmax.name]},
        attrs={"pooled_height": pooled_height, "pooled_width": pooled_width,
               "spatial_scale": spatial_scale},
    )
    return out


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    row_lengths=None, name=None):
    """Greedy bipartite matching (reference layers/detection.py:1059).
    dist_matrix [N, R, C] dense (padded rows; pass row_lengths [N] for
    ragged gt counts).  Returns (match_indices [N, C], match_dist [N, C])."""
    helper = LayerHelper("bipartite_match", name=name)
    idx = _out(helper, "int32")
    dist = _out(helper, "float32")
    inputs = {"DistMat": [dist_matrix.name]}
    if row_lengths is not None:
        inputs["RowLod"] = [row_lengths.name]
    helper.append_op(
        "bipartite_match", inputs=inputs,
        outputs={"ColToRowMatchIndices": [idx.name],
                 "ColToRowMatchDist": [dist.name]},
        attrs={"match_type": match_type, "dist_threshold": dist_threshold},
    )
    return idx, dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    """Gather per-batch targets by match index (reference
    layers/detection.py:1145).  input [N, B, K] dense padded.  Returns
    (out [N, M, K], out_weight [N, M, 1])."""
    helper = LayerHelper("target_assign", name=name)
    out = _out(helper, input.dtype)
    wt = _out(helper, "float32")
    inputs = {"X": [input.name], "MatchIndices": [matched_indices.name]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices.name]
    helper.append_op(
        "target_assign", inputs=inputs,
        outputs={"Out": [out.name], "OutWeight": [wt.name]},
        attrs={"mismatch_value": mismatch_value},
    )
    return out, wt


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd=None, im_info=None,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=True,
                      gt_lengths=None):
    """RPN target assignment (reference layers/detection.py:221).

    STATIC-SHAPE deviation from the reference: the reference gathers
    sampled anchors into dynamic [F, 4]/[F+B, 1] tensors; a CUDA graph
    needs fixed shapes, so every return spans all M anchors and sampling
    lives in weights.  Returns (predicted_scores [N, M, 1], predicted_location
    [N, M, 4], target_label [N, M], target_bbox [N, M, 4],
    bbox_inside_weight [N, M, 4], score_weight [N, M]); the RPN loss is
    sigmoid_ce(scores, label) * score_weight + |loc - target| *
    inside_weight, identical math to the reference's gathered form."""
    helper = LayerHelper("rpn_target_assign")
    label = _out(helper, "int32")
    score_w = _out(helper, "float32")
    tgt = _out(helper, anchor_box.dtype)
    inw = _out(helper, anchor_box.dtype)
    inputs = {"Anchor": [anchor_box.name], "GtBoxes": [gt_boxes.name]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd.name]
    if im_info is not None:
        inputs["ImInfo"] = [im_info.name]
    if gt_lengths is not None:
        inputs["GtLod"] = [gt_lengths.name]
    helper.append_op(
        "rpn_target_assign", inputs=inputs,
        outputs={"TargetLabel": [label.name], "ScoreWeight": [score_w.name],
                 "TargetBBox": [tgt.name], "BBoxInsideWeight": [inw.name]},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_straddle_thresh": rpn_straddle_thresh,
               "rpn_fg_fraction": rpn_fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "use_random": use_random},
    )
    return cls_logits, bbox_pred, label, tgt, inw, score_w


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0, name=None):
    """RPN proposals (reference layers/detection.py:2390).  Returns
    (rpn_rois [N, post_nms_top_n, 4], rpn_roi_probs [N, post_nms_top_n, 1])
    padded static blocks (prob 0 = empty slot) in place of the reference's
    LoD output."""
    if eta != 1.0:
        raise NotImplementedError("generate_proposals: adaptive NMS (eta != 1)")
    helper = LayerHelper("generate_proposals", name=name)
    rois = _out(helper, scores.dtype)
    probs = _out(helper, scores.dtype)
    helper.append_op(
        "generate_proposals",
        inputs={"Scores": [scores.name], "BboxDeltas": [bbox_deltas.name],
                "ImInfo": [im_info.name], "Anchors": [anchors.name],
                "Variances": [variances.name]},
        outputs={"RpnRois": [rois.name], "RpnRoiProbs": [probs.name]},
        attrs={"pre_nms_topN": pre_nms_top_n, "post_nms_topN": post_nms_top_n,
               "nms_thresh": nms_thresh, "min_size": min_size},
    )
    return rois, probs


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_version="integral", gt_lengths=None):
    """Batch mAP (reference layers/detection.py:966).  detect_res
    [N, D, 6] (label, score, box; label -1 pad — multiclass_nms output),
    label [N, B, 5] (class, box) padded.  Cross-batch accumulation:
    metrics.DetectionMAP."""
    helper = LayerHelper("detection_map")
    out = _out(helper, "float32")
    inputs = {"DetectRes": [detect_res.name], "Label": [label.name]}
    if gt_lengths is not None:
        inputs["GtLod"] = [gt_lengths.name]
    helper.append_op(
        "detection_map", inputs=inputs, outputs={"MAP": [out.name]},
        attrs={"class_num": class_num, "background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version},
    )
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None,
             gt_lengths=None):
    """SSD multibox loss (reference layers/detection.py:1242).  Dense gt:
    gt_box [N, B, 4] padded + gt_lengths [N]; returns [N, 1] loss."""
    if mining_type != "max_negative":
        raise ValueError("Only support mining_type == max_negative now.")
    helper = LayerHelper("ssd_loss")
    out = _out(helper, location.dtype)
    inputs = {"Location": [location.name], "Confidence": [confidence.name],
              "GtBox": [gt_box.name], "GtLabel": [gt_label.name],
              "PriorBox": [prior_box.name]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var.name]
    if gt_lengths is not None:
        inputs["GtLod"] = [gt_lengths.name]
    helper.append_op(
        "ssd_loss", inputs=inputs, outputs={"Loss": [out.name]},
        attrs={"background_label": background_label,
               "overlap_threshold": overlap_threshold,
               "neg_pos_ratio": neg_pos_ratio, "neg_overlap": neg_overlap,
               "loc_loss_weight": loc_loss_weight,
               "conf_loss_weight": conf_loss_weight, "normalize": normalize,
               "match_type": match_type},
    )
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head (reference layers/detection.py multi_box_head):
    per-feature-map prior_box + loc/conf conv branches, concatenated to
    [N, num_priors, 4] / [N, num_priors, num_classes] plus the stacked
    priors/variances."""
    from . import nn as _nn
    from . import tensor as _tensor
    from ..ops.detection_ops import expand_aspect_ratios

    n_layer = len(inputs)
    if min_sizes is None:
        assert min_ratio is not None and max_ratio is not None
        if n_layer < 3:
            raise ValueError(
                "multi_box_head: ratio-based sizing needs >= 3 feature maps "
                "(the reference divides by num_layer - 2); pass min_sizes/"
                "max_sizes explicitly for fewer")
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_layer - 2))
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.10] + min_sizes[:n_layer - 1]
        max_sizes = [base_size * 0.20] + max_sizes[:n_layer - 1]

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i]
        ms_list = ms if isinstance(ms, (list, tuple)) else [ms]
        mx = None
        if max_sizes:
            mxi = max_sizes[i]
            mx = mxi if isinstance(mxi, (list, tuple)) else [mxi]
        ar = aspect_ratios[i]
        ar = ar if isinstance(ar, (list, tuple)) else [ar]
        st = steps[i] if steps else (step_w[i] if step_w else 0.0,
                                     step_h[i] if step_h else 0.0)
        st = st if isinstance(st, (list, tuple)) else (st, st)
        box, var = prior_box(feat, image, ms_list, mx, ar, variance, flip,
                             clip, (float(st[0]), float(st[1])), offset,
                             min_max_aspect_ratios_order=min_max_aspect_ratios_order)
        boxes_l.append(_nn.reshape(box, [-1, 4]))
        vars_l.append(_nn.reshape(var, [-1, 4]))
        npriors = (len(ms_list) * len(expand_aspect_ratios(ar, flip))
                   + (len(mx) if mx else 0))
        loc = _nn.conv2d(feat, npriors * 4, kernel_size, padding=pad,
                         stride=stride)
        loc = _nn.transpose(loc, [0, 2, 3, 1])
        locs.append(_nn.reshape(loc, [0, -1, 4]))
        cnf = _nn.conv2d(feat, npriors * num_classes, kernel_size,
                         padding=pad, stride=stride)
        cnf = _nn.transpose(cnf, [0, 2, 3, 1])
        confs.append(_nn.reshape(cnf, [0, -1, num_classes]))

    mbox_locs = _tensor.concat(locs, axis=1)
    mbox_confs = _tensor.concat(confs, axis=1)
    boxes = _tensor.concat(boxes_l, axis=0)
    variances = _tensor.concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """SSD inference head (reference layers/detection.py:440): decode loc
    deltas against priors, softmax scores, multiclass NMS.  Static-shape
    output: [N, keep_top_k, 6] padded (label -1 empty slots)."""
    from . import nn as _nn

    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    probs = _nn.softmax(scores)             # [N, P, C]
    probs_t = _nn.transpose(probs, [0, 2, 1])  # [N, C, P]
    return multiclass_nms(decoded, probs_t, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, nms_eta=nms_eta,
                          background_label=background_label)


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, rois_batch=None, name=None):
    """Position-sensitive RoI pool (reference layers/nn.py psroi_pool);
    dense [R, 4] rois + optional batch-index vector."""
    helper = LayerHelper("psroi_pool", name=name)
    out = _out(helper, input.dtype)
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch.name]
    helper.append_op(
        "psroi_pool", inputs=inputs, outputs={"Out": [out.name]},
        attrs={"output_channels": output_channels,
               "spatial_scale": spatial_scale,
               "pooled_height": pooled_height, "pooled_width": pooled_width},
    )
    return out


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd=None, im_info=None,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4, gt_lengths=None):
    """RetinaNet target assignment (reference layers/detection.py:63).

    STATIC-SHAPE form (same deviation as rpn_target_assign): returns
    (predicted_scores, predicted_location, target_label, target_bbox,
    bbox_inside_weight, fg_num, score_weight) spanning all anchors —
    target_label holds the gt class (0 background, -1 ignored), fg_num is
    the per-image foreground count + 1 (the reference's focal-loss
    normalizer)."""
    helper = LayerHelper("retinanet_target_assign")
    label = _out(helper, "int32")
    score_w = _out(helper, "float32")
    tgt = _out(helper, anchor_box.dtype)
    inw = _out(helper, anchor_box.dtype)
    fg_num = _out(helper, "int32")
    inputs = {"Anchor": [anchor_box.name], "GtBoxes": [gt_boxes.name],
              "GtLabels": [gt_labels.name]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd.name]
    if gt_lengths is not None:
        inputs["GtLod"] = [gt_lengths.name]
    helper.append_op(
        "retinanet_target_assign", inputs=inputs,
        outputs={"TargetLabel": [label.name], "ScoreWeight": [score_w.name],
                 "TargetBBox": [tgt.name], "BBoxInsideWeight": [inw.name],
                 "FgNum": [fg_num.name]},
        attrs={"positive_overlap": positive_overlap,
               "negative_overlap": negative_overlap},
    )
    return cls_logits, bbox_pred, label, tgt, inw, fg_num, score_w


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """RetinaNet inference head (reference layers/detection.py
    retinanet_detection_output / retinanet_detection_output_op.cc): per-FPN-
    level deltas decode against their anchors, sigmoid scores, class-wise
    NMS across levels.  Static-shape [N, keep_top_k, 6] output block.
    `bboxes`/`scores`: lists of [N, Ai, 4] / [N, Ai, C]; `anchors`: list of
    [Ai, 4] pixel-space anchors."""
    from . import nn as _nn
    from . import tensor as _tensor

    box_all = _tensor.concat(bboxes, axis=1) if len(bboxes) > 1 else bboxes[0]
    score_all = _tensor.concat(scores, axis=1) if len(scores) > 1 else scores[0]
    anchor_all = (_tensor.concat(anchors, axis=0) if len(anchors) > 1
                  else anchors[0])
    decoded = box_coder(anchor_all, None, box_all,
                        code_type="decode_center_size", box_normalized=False)
    decoded = box_clip(decoded, im_info)
    probs = _nn.sigmoid(score_all)              # [N, P, C]
    probs_t = _nn.transpose(probs, [0, 2, 1])   # [N, C, P]
    return multiclass_nms(decoded, probs_t, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold, nms_eta=nms_eta,
                          background_label=-1, normalized=False)


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info=None, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.25,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=None, use_random=True,
                             is_cls_agnostic=False, is_cascade_rcnn=False,
                             gt_lengths=None):
    """RCNN stage-2 RoI sampling (reference layers/detection.py
    generate_proposal_labels).  STATIC-SHAPE deviation: each image emits
    exactly batch_size_per_im rows and a SampleWeight column marks drawn
    rows — returns (rois, labels_int32, bbox_targets, bbox_inside_weights,
    bbox_outside_weights, sample_weight)."""
    if is_cls_agnostic or is_cascade_rcnn:
        raise NotImplementedError(
            "generate_proposal_labels: cls-agnostic / cascade modes")
    if class_nums is None:
        raise ValueError("generate_proposal_labels: class_nums is required")
    helper = LayerHelper("generate_proposal_labels")
    rois = _out(helper, rpn_rois.dtype)
    labels = _out(helper, "int32")
    tgt = _out(helper, rpn_rois.dtype)
    inw = _out(helper, rpn_rois.dtype)
    outw = _out(helper, rpn_rois.dtype)
    sw = _out(helper, "float32")
    inputs = {"RpnRois": [rpn_rois.name], "GtClasses": [gt_classes.name],
              "GtBoxes": [gt_boxes.name]}
    if is_crowd is not None:
        inputs["IsCrowd"] = [is_crowd.name]
    if im_info is not None:
        inputs["ImInfo"] = [im_info.name]
    if gt_lengths is not None:
        inputs["GtLod"] = [gt_lengths.name]
    helper.append_op(
        "generate_proposal_labels", inputs=inputs,
        outputs={"Rois": [rois.name], "LabelsInt32": [labels.name],
                 "BboxTargets": [tgt.name], "BboxInsideWeights": [inw.name],
                 "BboxOutsideWeights": [outw.name],
                 "SampleWeight": [sw.name]},
        attrs={"batch_size_per_im": batch_size_per_im,
               "fg_fraction": fg_fraction, "fg_thresh": fg_thresh,
               "bg_thresh_hi": bg_thresh_hi, "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums, "use_random": use_random},
    )
    return rois, labels, tgt, inw, outw, sw


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, name=None):
    """FPN level routing (reference layers/detection.py
    distribute_fpn_proposals).  STATIC-SHAPE deviation: rois are not
    physically split; every level receives the full roi tensor plus a
    [R] selection mask (pool on every level, select by mask — the
    accelerator FPN formulation), and restore_ind is the identity.
    Returns (multi_rois, restore_ind, multi_masks)."""
    helper = LayerHelper("distribute_fpn_proposals", name=name)
    L = max_level - min_level + 1
    mask = _out(helper, "float32")
    restore = _out(helper, "int32")
    helper.append_op(
        "distribute_fpn_proposals",
        inputs={"FpnRois": [fpn_rois.name]},
        outputs={"MultiLevelMask": [mask.name], "RestoreIndex": [restore.name]},
        attrs={"min_level": min_level, "max_level": max_level,
               "refer_level": refer_level, "refer_scale": refer_scale},
    )
    from . import nn as _nn

    multi_rois = [fpn_rois] * L
    # slice the [L, R] mask into per-level [R] rows
    multi_masks = []
    for i in range(L):
        row = _nn.slice(mask, axes=[0], starts=[i], ends=[i + 1])
        multi_masks.append(_nn.reshape(row, [-1]))
    return multi_rois, restore, multi_masks


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, name=None):
    """reference layers/detection.py collect_fpn_proposals: global top-k
    over the concatenated per-level proposals.  Returns a padded
    [post_nms_top_n, 4] block (score 0 = empty slot)."""
    helper = LayerHelper("collect_fpn_proposals", name=name)
    rois = _out(helper, multi_rois[0].dtype)
    scores = _out(helper, "float32")
    helper.append_op(
        "collect_fpn_proposals",
        inputs={"MultiLevelRois": [r.name for r in multi_rois],
                "MultiLevelScores": [s.name for s in multi_scores]},
        outputs={"FpnRois": [rois.name], "RoisScores": [scores.name]},
        attrs={"post_nms_topN": post_nms_top_n},
    )
    return rois


def box_decoder_and_assign(prior_box, prior_box_var, target_box, box_score,
                           box_clip=None, name=None):
    """reference layers/detection.py box_decoder_and_assign (R-FCN):
    per-class decode + best-class assignment.  prior_box_var here is the
    4-list of variances (the reference also accepts a tensor)."""
    import numpy as _np

    helper = LayerHelper("box_decoder_and_assign", name=name)
    decoded = _out(helper, target_box.dtype)
    assigned = _out(helper, target_box.dtype)
    inputs = {"PriorBox": [prior_box.name], "TargetBox": [target_box.name],
              "BoxScore": [box_score.name]}
    attrs = {"box_clip": float(box_clip) if box_clip is not None
             else float(_np.log(1000.0 / 16.0))}
    if isinstance(prior_box_var, (list, tuple)):
        attrs["box_var"] = list(prior_box_var)
    elif prior_box_var is not None:  # tensor variances
        inputs["PriorBoxVar"] = [prior_box_var.name]
    helper.append_op("box_decoder_and_assign", inputs=inputs,
                     outputs={"DecodeBox": [decoded.name],
                              "OutputAssignBox": [assigned.name]},
                     attrs=attrs)
    return decoded, assigned


def polygon_box_transform(input, name=None):
    """reference layers/detection.py polygon_box_transform (EAST)."""
    helper = LayerHelper("polygon_box_transform", name=name)
    out = _out(helper, input.dtype, shape=input.shape)
    helper.append_op("polygon_box_transform", inputs={"Input": [input.name]},
                     outputs={"Output": [out.name]})
    return out


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              rois_batch=None, name=None):
    """reference layers/detection.py roi_perspective_transform; dense
    [R, 8] quad rois + optional batch-index vector."""
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = _out(helper, input.dtype)
    inputs = {"X": [input.name], "ROIs": [rois.name]}
    if rois_batch is not None:
        inputs["RoisBatch"] = [rois_batch.name]
    helper.append_op(
        "roi_perspective_transform", inputs=inputs,
        outputs={"Out": [out.name]},
        attrs={"transformed_height": transformed_height,
               "transformed_width": transformed_width,
               "spatial_scale": spatial_scale},
    )
    return out


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution,
                         gt_poly_lens=None, gt_lengths=None):
    """Mask-RCNN mask targets (reference layers/detection.py
    generate_mask_labels).  STATIC-SHAPE deviation: operates on the
    generate_proposal_labels outputs; gt_segms is [N, G, P, 2] padded
    polygons (one polygon per gt) + optional point/gt counts.  Returns
    (mask_rois, roi_has_mask_int32, mask_int32)."""
    helper = LayerHelper("generate_mask_labels")
    masks = _out(helper, "int32")
    has = _out(helper, "int32")
    mask_rois = _out(helper, rois.dtype)
    inputs = {"Rois": [rois.name], "LabelsInt32": [labels_int32.name],
              "GtSegms": [gt_segms.name]}
    if gt_poly_lens is not None:
        inputs["GtPolyLens"] = [gt_poly_lens.name]
    if gt_lengths is not None:
        inputs["GtLod"] = [gt_lengths.name]
    helper.append_op(
        "generate_mask_labels", inputs=inputs,
        outputs={"MaskInt32": [masks.name], "RoiHasMaskInt32": [has.name],
                 "MaskRois": [mask_rois.name]},
        attrs={"num_classes": num_classes, "resolution": resolution},
    )
    return mask_rois, has, masks
