"""Reduced detection programs and the one-op cases of the detection family
(ops/detection_ops.py and the nn and host ops beside it), the data that
holds the port against a reference: against the JAX package on the CPU
(tests/test_torch_detection.py, tests/test_torch_ops.py) and the card
against the CPU (chip_smoke.py's detection_parity).  Numpy inputs from
fixed seeds; numpy only, so either package's `fluid` builds them.  A case
is (id, op type, inputs, attrs, output slots); attrs' `out_dtypes` declares
output var dtypes and is not an attr of the op.  `build_one_op` builds one
case's program; MODELS maps a name to (builder, feed maker) of a reduced
model; `hold_close` is the comparison both callers use."""
import numpy as np

r = np.random.RandomState(2015)


def F(*s):
    return r.randn(*s).astype(np.float32)


def _boxes(*lead, lo=0.0, hi=1.0, min_wh=0.05, max_wh=0.5):
    """Corner boxes [..., 4] inside [lo, hi]."""
    xy = r.uniform(lo, hi * 0.7, lead + (2,))
    wh = r.uniform(min_wh * hi, max_wh * hi, lead + (2,))
    return np.concatenate([xy, np.minimum(xy + wh, hi)], -1).astype(np.float32)


# --- inputs ---------------------------------------------------------------
GT_CORNERS = _boxes(2, 5)
NMS_SCORES = r.rand(2, 4, 30).astype(np.float32)
NMS_SCORES[:, :, 10:20] = NMS_SCORES[:, :, :10]        # exact score ties
NMS_BOXES = _boxes(2, 30)
NMS_BOXES[:, 20:25] = NMS_BOXES[:, 0:5]                 # exact duplicate boxes
YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
YOLO_GT = np.concatenate([r.uniform(0.1, 0.9, (2, 6, 2)), r.uniform(0.05, 0.4, (2, 6, 2))],
                         -1).astype(np.float32)
YOLO_GT[1, 4:] = 0.0  # padding ground truths
ANCHOR_GRID = np.concatenate([np.stack(np.meshgrid(np.arange(4) * 16 + 8, np.arange(4) * 16 + 8),
                                       -1).reshape(-1, 2) - 12,
                              np.stack(np.meshgrid(np.arange(4) * 16 + 8, np.arange(4) * 16 + 8),
                                       -1).reshape(-1, 2) + 12], 1).astype(np.float32)
PIX_GT = np.array([[[6, 6, 26, 26], [40, 40, 60, 60], [0, 0, 0, 0]],
                   [[10, 30, 34, 58], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
QUADS = np.array([[1, 1, 9, 2, 10, 8, 2, 9], [3, 0, 14, 3, 12, 12, 0, 10]], np.float32)
DET = np.full((2, 6, 6), -1.0, np.float32)
DET[:, :4, 0] = [[1, 2, 1, 2], [1, 1, 2, 2]]
DET[:, :4, 1] = r.rand(2, 4)
DET[:, :4, 2:] = _boxes(2, 4)
DET_GT = np.zeros((2, 3, 6), np.float32)
DET_GT[:, :, 0] = [[1, 2, 1], [2, 1, 0]]
DET_GT[:, :, 1] = [[0, 1, 0], [0, 0, 0]]
DET_GT[:, :, 2:] = DET[:, :3, 2:] + r.uniform(-0.05, 0.05, (2, 3, 4))

# (id, op, inputs, attrs, out slots)
DETECTION_CASES = [
    ("prior_box", "prior_box", {"Input": F(2, 3, 4, 5), "Image": F(2, 3, 32, 40)},
     {"min_sizes": [4.0, 8.0], "max_sizes": [8.0, 14.0], "aspect_ratios": [2.0, 3.0],
      "variances": [0.1, 0.1, 0.2, 0.2], "flip": True, "clip": True}, ["Boxes", "Variances"]),
    ("prior_box_mmar_steps", "prior_box", {"Input": F(1, 2, 3, 3), "Image": F(1, 3, 30, 30)},
     {"min_sizes": [6.0], "max_sizes": [12.0], "aspect_ratios": [2.0], "flip": False,
      "step_w": 9.0, "step_h": 11.0, "offset": 0.3, "min_max_aspect_ratios_order": True},
     ["Boxes", "Variances"]),
    ("anchor_generator", "anchor_generator", {"Input": F(1, 2, 3, 4)},
     {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0], "stride": [16.0, 16.0]},
     ["Anchors", "Variances"]),
    ("density_prior_box", "density_prior_box", {"Input": F(1, 2, 3, 3), "Image": F(1, 3, 24, 24)},
     {"fixed_sizes": [4.0, 8.0], "fixed_ratios": [1.0, 2.0], "densities": [2, 1]},
     ["Boxes", "Variances"]),
    ("iou_similarity", "iou_similarity", {"X": _boxes(5), "Y": _boxes(7)}, {}, ["Out"]),
    ("iou_similarity_pixels", "iou_similarity", {"X": _boxes(5, hi=50.0), "Y": _boxes(7, hi=50.0)},
     {"box_normalized": False}, ["Out"]),
    ("box_coder_encode", "box_coder", {"PriorBox": _boxes(6), "PriorBoxVar": np.abs(F(6, 4)) + 0.1,
                                       "TargetBox": _boxes(4)}, {"code_type": "encode_center_size"},
     ["OutputBox"]),
    ("box_coder_decode_batched", "box_coder",
     {"PriorBox": _boxes(6), "PriorBoxVar": np.abs(F(6, 4)) + 0.1, "TargetBox": F(2, 6, 4) * 0.5},
     {"code_type": "decode_center_size"}, ["OutputBox"]),
    ("box_coder_decode_pixels", "box_coder", {"PriorBox": _boxes(6, hi=40.0),
                                              "TargetBox": F(6, 4) * 0.3},
     {"code_type": "decode_center_size", "box_normalized": False}, ["OutputBox"]),
    ("box_clip", "box_clip", {"Input": _boxes(2, 5, hi=80.0) - 10.0,
                              "ImInfo": np.array([[40, 50, 0.8], [60, 30, 1.0]], np.float32)},
     {}, ["Output"]),
    ("yolo_box", "yolo_box", {"X": F(2, 3 * 8, 4, 5), "ImgSize": np.array([[128, 160], [96, 64]],
                                                                         np.int32)},
     {"anchors": YOLO_ANCHORS[:6], "class_num": 3, "conf_thresh": 0.3, "downsample_ratio": 32},
     ["Boxes", "Scores"]),
    ("multiclass_nms_ties", "multiclass_nms", {"BBoxes": NMS_BOXES, "Scores": NMS_SCORES},
     {"score_threshold": 0.2, "nms_top_k": 20, "keep_top_k": 25, "nms_threshold": 0.3,
      "background_label": 0}, ["Out"]),
    ("multiclass_nms_all_classes", "multiclass_nms", {"BBoxes": NMS_BOXES * 50,
                                                       "Scores": NMS_SCORES},
     {"score_threshold": 0.0, "nms_top_k": -1, "keep_top_k": -1, "nms_threshold": 0.5,
      "background_label": -1, "normalized": False}, ["Out"]),
    ("roi_align", "roi_align", {"X": F(2, 3, 8, 8), "ROIs": _boxes(4, hi=16.0) - 2.0,
                                "RoisBatch": np.array([0, 1, 1, 0], np.int32)},
     {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5, "sampling_ratio": 2}, ["Out"]),
    ("roi_align_adaptive", "roi_align", {"X": F(1, 2, 6, 7), "ROIs": _boxes(3, hi=7.0)},
     {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 1.0, "sampling_ratio": -1}, ["Out"]),
    ("roi_pool", "roi_pool", {"X": F(2, 3, 8, 8), "ROIs": np.array(
        [[0, 0, 7, 7], [2, 2, 11, 11], [1, 0, 5, 3], [6, 6, 20, 20]], np.float32),
        "RoisBatch": np.array([0, 1, 1, 0], np.int32)},
     {"pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5,
      "out_dtypes": {"Argmax": "int64"}}, ["Out", "Argmax"]),
    ("psroi_pool", "psroi_pool", {"X": F(2, 2 * 2 * 3, 8, 8), "ROIs": _boxes(3, hi=14.0),
                                  "RoisBatch": np.array([1, 0, 1], np.int32)},
     {"output_channels": 2, "pooled_height": 2, "pooled_width": 3, "spatial_scale": 0.5},
     ["Out"]),
    ("sigmoid_focal_loss", "sigmoid_focal_loss",
     {"X": F(6, 3), "Label": np.array([[0], [1], [3], [-1], [2], [1]], np.int32),
      "FgNum": np.array([3], np.int32)}, {"gamma": 2.0, "alpha": 0.25}, ["Out"]),
    ("yolov3_loss", "yolov3_loss",
     {"X": F(2, 3 * 8, 5, 5) * 0.5, "GTBox": YOLO_GT,
      "GTLabel": r.randint(0, 3, (2, 6)).astype(np.int32),
      "GTScore": r.uniform(0.5, 1.0, (2, 6)).astype(np.float32)},
     {"anchors": YOLO_ANCHORS, "anchor_mask": [0, 1, 2], "class_num": 3, "ignore_thresh": 0.5,
      "downsample_ratio": 8, "use_label_smooth": True,
      "out_dtypes": {"GTMatchMask": "int32"}}, ["Loss", "ObjectnessMask", "GTMatchMask"]),
    ("bipartite_match", "bipartite_match",
     {"DistMat": r.rand(2, 4, 7).astype(np.float32), "RowLod": np.array([4, 2], np.int32)},
     {"match_type": "bipartite", "out_dtypes": {"ColToRowMatchIndices": "int32"}},
     ["ColToRowMatchIndices", "ColToRowMatchDist"]),
    ("bipartite_match_per_prediction", "bipartite_match",
     {"DistMat": r.rand(3, 6).astype(np.float32)},
     {"match_type": "per_prediction", "dist_threshold": 0.4,
      "out_dtypes": {"ColToRowMatchIndices": "int32"}},
     ["ColToRowMatchIndices", "ColToRowMatchDist"]),
    ("target_assign", "target_assign",
     {"X": F(2, 3, 4), "MatchIndices": np.array([[0, -1, 2, 1, -1], [-1, 1, 1, 0, 2]], np.int32),
      "NegIndices": np.array([[1, 4, -1], [0, -1, -1]], np.int32)},
     {"mismatch_value": -2}, ["Out", "OutWeight"]),
    ("rpn_target_assign", "rpn_target_assign",
     {"Anchor": ANCHOR_GRID, "GtBoxes": PIX_GT, "GtLod": np.array([2, 1], np.int32),
      "ImInfo": np.array([[64, 64, 1.0], [64, 56, 1.0]], np.float32),
      "IsCrowd": np.array([[0, 0, 0], [0, 0, 0]], np.int32)},
     {"rpn_batch_size_per_im": 8, "rpn_straddle_thresh": 0.0, "use_random": False,
      "out_dtypes": {"TargetLabel": "int32"}},
     ["TargetLabel", "ScoreWeight", "TargetBBox", "BBoxInsideWeight"]),
    ("retinanet_target_assign", "retinanet_target_assign",
     {"Anchor": ANCHOR_GRID, "GtBoxes": PIX_GT, "GtLabels": np.array([[1, 2, 0], [3, 0, 0]],
                                                                      np.int32),
      "GtLod": np.array([2, 1], np.int32)},
     {"positive_overlap": 0.5, "negative_overlap": 0.4,
      "out_dtypes": {"TargetLabel": "int32", "FgNum": "int32"}},
     ["TargetLabel", "ScoreWeight", "TargetBBox", "BBoxInsideWeight", "FgNum"]),
    ("generate_proposal_labels", "generate_proposal_labels",
     {"RpnRois": _boxes(2, 10, hi=60.0), "GtClasses": np.array([[1, 2, 0], [3, 0, 0]], np.int32),
      "GtBoxes": PIX_GT, "GtLod": np.array([2, 1], np.int32),
      "ImInfo": np.array([[64, 64, 1.0], [64, 64, 2.0]], np.float32)},
     {"batch_size_per_im": 8, "fg_fraction": 0.25, "fg_thresh": 0.5, "bg_thresh_hi": 0.5,
      "bg_thresh_lo": 0.0, "bbox_reg_weights": [0.1, 0.1, 0.2, 0.2], "class_nums": 4,
      "use_random": False, "out_dtypes": {"LabelsInt32": "int32"}},
     ["Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights", "BboxOutsideWeights",
      "SampleWeight"]),
    ("generate_proposals", "generate_proposals",
     {"Scores": r.rand(2, 2, 4, 4).astype(np.float32), "BboxDeltas": F(2, 8, 4, 4) * 0.2,
      "ImInfo": np.array([[64, 64, 1.0], [48, 64, 1.0]], np.float32),
      "Anchors": np.repeat(ANCHOR_GRID.reshape(4, 4, 1, 4), 2, 2) * [1, 1, 1.2, 1.2],
      "Variances": np.ones((4, 4, 2, 4), np.float32)},
     {"pre_nms_topN": 20, "post_nms_topN": 8, "nms_thresh": 0.5, "min_size": 2.0},
     ["RpnRois", "RpnRoiProbs"]),
    ("detection_map_integral", "detection_map",
     {"DetectRes": DET, "Label": DET_GT, "GtLod": np.array([3, 2], np.int32)},
     {"class_num": 3, "overlap_threshold": 0.5, "ap_type": "integral"}, ["MAP"]),
    ("detection_map_11point_difficult", "detection_map", {"DetectRes": DET, "Label": DET_GT},
     {"class_num": 3, "overlap_threshold": 0.3, "ap_type": "11point",
      "evaluate_difficult": False}, ["MAP"]),
    ("ssd_loss", "ssd_loss",
     {"Location": F(2, 12, 4) * 0.3, "Confidence": F(2, 12, 3),
      "GtBox": GT_CORNERS[:, :3], "GtLabel": np.array([[1, 2, 1], [2, 0, 0]], np.int32),
      "PriorBox": _boxes(12), "PriorBoxVar": np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32),
                                                     (12, 1)),
      "GtLod": np.array([3, 1], np.int32)},
     {"background_label": 0, "overlap_threshold": 0.3, "neg_pos_ratio": 2.0, "neg_overlap": 0.5},
     ["Loss"]),
    ("distribute_fpn_proposals", "distribute_fpn_proposals",
     {"FpnRois": np.array([[0, 0, s - 1, s - 1] for s in (16, 32, 64, 112, 224, 448, 900)],
                          np.float32)},
     {"min_level": 2, "max_level": 5, "refer_level": 4, "refer_scale": 224,
      "out_dtypes": {"RestoreIndex": "int32"}}, ["MultiLevelMask", "RestoreIndex"]),
    ("collect_fpn_proposals", "collect_fpn_proposals",
     {"MultiLevelRois": [_boxes(2, 6, hi=50.0), _boxes(2, 4, hi=50.0)],
      "MultiLevelScores": [r.rand(2, 6).astype(np.float32), r.rand(2, 4, 1).astype(np.float32)]},
     {"post_nms_topN": 12}, ["FpnRois", "RoisScores"]),
    ("box_decoder_and_assign", "box_decoder_and_assign",
     {"PriorBox": _boxes(4, hi=30.0), "TargetBox": F(4, 12) * 0.3, "BoxScore": r.rand(4, 3).astype(
         np.float32)}, {"box_clip": 4.135, "box_var": [0.1, 0.1, 0.2, 0.2]},
     ["DecodeBox", "OutputAssignBox"]),
    ("polygon_box_transform", "polygon_box_transform", {"Input": F(2, 8, 3, 4)}, {}, ["Output"]),
    ("roi_perspective_transform", "roi_perspective_transform",
     {"X": F(2, 2, 12, 14), "ROIs": QUADS, "RoisBatch": np.array([1, 0], np.int32)},
     {"transformed_height": 4, "transformed_width": 6, "spatial_scale": 1.0}, ["Out"]),
    ("deformable_psroi_pooling", "deformable_psroi_pooling",
     {"Input": F(2, 2 * 2 * 2, 9, 9), "ROIs": _boxes(3, hi=14.0), "Trans": F(3, 2, 2, 2) * 0.5,
      "RoisBatch": np.array([0, 1, 1], np.int32)},
     {"no_trans": False, "spatial_scale": 0.5, "output_dim": 2, "group_size": [2, 2],
      "pooled_height": 2, "pooled_width": 2, "part_size": [2, 2], "sample_per_part": 2,
      "trans_std": 0.1}, ["Output", "TopCount"]),
    ("deformable_psroi_pooling_no_trans", "deformable_psroi_pooling",
     {"Input": F(1, 3, 8, 8), "ROIs": _boxes(2, hi=8.0)},
     {"no_trans": True, "spatial_scale": 1.0, "output_dim": 3, "group_size": [1, 1],
      "pooled_height": 3, "pooled_width": 2, "part_size": [3, 2], "sample_per_part": 2},
     ["Output", "TopCount"]),
    ("generate_mask_labels", "generate_mask_labels",
     {"Rois": np.array([[[0, 0, 8, 8], [20, 20, 28, 28], [1, 1, 7, 9]]], np.float32),
      "LabelsInt32": np.array([[2, 0, 1]], np.int32),
      "GtSegms": np.array([[[[0, 0], [4, 0], [4, 8], [0, 8], [0, 0]],
                            [[1, 1], [7, 2], [6, 9], [0, 0], [0, 0]]]], np.float32),
      "GtPolyLens": np.array([[4, 3]], np.int32)},
     {"num_classes": 3, "resolution": 4,
      "out_dtypes": {"MaskInt32": "int32", "RoiHasMaskInt32": "int32"}},
     ["MaskInt32", "RoiHasMaskInt32", "MaskRois"]),
]


# --- the nn and host ops of the detection slice (ROADMAP A8.6) -------------
r15 = np.random.RandomState(15)
H32 = lambda *s: r15.randn(*s).astype("float32")  # noqa: E731
NN_CASES = [
    ("depthwise_conv2d", "depthwise_conv2d", {"Input": H32(2, 4, 7, 7), "Filter": H32(4, 1, 3, 3)},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1], "groups": 4}, ["Output"], 1e-5),
    ("conv2d_transpose", "conv2d_transpose", {"Input": H32(2, 3, 5, 5), "Filter": H32(3, 4, 3, 3)},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1], "groups": 1}, ["Output"], 1e-5),
    ("conv2d_transpose_groups_dil", "conv2d_transpose",
     {"Input": H32(2, 4, 5, 6), "Filter": H32(4, 3, 3, 2)},
     {"strides": [1, 2], "paddings": [2, 0], "dilations": [2, 1], "groups": 2}, ["Output"], 1e-5),
    ("depthwise_conv2d_transpose", "depthwise_conv2d_transpose",
     {"Input": H32(2, 3, 4, 4), "Filter": H32(3, 1, 4, 4)},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1], "groups": 3}, ["Output"], 1e-5),
    ("conv3d_transpose", "conv3d_transpose", {"Input": H32(1, 2, 3, 4, 3), "Filter": H32(2, 3, 2, 3, 2)},
     {"strides": [2, 1, 2], "paddings": [0, 1, 0], "dilations": [1, 1, 1], "groups": 1},
     ["Output"], 1e-5),
    ("bilinear_align_corners", "bilinear_interp", {"X": H32(2, 3, 5, 7)},
     {"out_h": 9, "out_w": 4, "align_corners": True}, ["Out"], 1e-5),
    ("bilinear_align_mode_1", "bilinear_interp", {"X": H32(2, 3, 5, 7)},
     {"out_h": 8, "out_w": 11, "align_corners": False, "align_mode": 1}, ["Out"], 1e-5),
    ("bilinear_half_pixel", "bilinear_interp", {"X": H32(2, 3, 5, 7)},
     {"out_h": 8, "out_w": 3, "align_corners": False, "align_mode": 0}, ["Out"], 1e-5),
    ("bilinear_scale", "bilinear_interp", {"X": H32(1, 2, 4, 6)},
     {"out_h": 0, "out_w": 0, "scale": 1.5, "align_corners": True}, ["Out"], 1e-5),
    ("nearest_align_corners", "nearest_interp", {"X": H32(2, 3, 5, 7)},
     {"out_h": 10, "out_w": 14, "align_corners": True}, ["Out"], 0.0),
    ("nearest_scale_2", "nearest_interp", {"X": H32(2, 3, 19, 19)},
     {"out_h": 0, "out_w": 0, "scale": 2.0, "align_corners": True}, ["Out"], 0.0),
    ("nearest_floor", "nearest_interp", {"X": H32(2, 3, 5, 7)},
     {"out_h": 9, "out_w": 4, "align_corners": False}, ["Out"], 0.0),
    ("group_norm", "group_norm", {"X": H32(2, 6, 4, 5), "Scale": H32(6), "Bias": H32(6)},
     {"groups": 3, "epsilon": 1e-5}, ["Y", "Mean", "Variance"], 1e-5),
    ("instance_norm", "instance_norm", {"X": H32(2, 3, 4, 5), "Scale": H32(3), "Bias": H32(3)},
     {"epsilon": 1e-5}, ["Y", "SavedMean", "SavedVariance"], 1e-5),
    ("prelu_all", "prelu", {"X": H32(2, 3, 4), "Alpha": np.array([0.25], np.float32)},
     {"mode": "all"}, ["Out"], 0.0),
    ("prelu_channel", "prelu", {"X": H32(2, 3, 4, 4), "Alpha": H32(3)}, {"mode": "channel"},
     ["Out"], 0.0),
    ("prelu_element", "prelu", {"X": H32(2, 3, 4), "Alpha": H32(3, 4)}, {"mode": "element"},
     ["Out"], 0.0),
    ("log_softmax", "log_softmax", {"X": H32(3, 7)}, {"axis": -1}, ["Out"], 1e-6),
    ("arg_max", "arg_max", {"X": np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 1.0, 2.0]], np.float32)},
     {"axis": 1, "out_dtype": "int64"}, ["Out"], 0.0),
    ("arg_min_axis0", "arg_min", {"X": np.array([[1.0, 0.0, 3.0], [1.0, 2.0, 0.0]], np.float32)},
     {"axis": 0, "out_dtype": "int64"}, ["Out"], 0.0),
    ("pad2d_constant", "pad2d", {"X": H32(2, 3, 4, 5)},
     {"paddings": [1, 2, 0, 3], "mode": "constant", "pad_value": 0.5}, ["Out"], 0.0),
    ("pad2d_reflect", "pad2d", {"X": H32(2, 3, 4, 5)},
     {"paddings": [2, 1, 3, 1], "mode": "reflect"}, ["Out"], 0.0),
    ("pad2d_edge", "pad2d", {"X": H32(2, 3, 4, 5)}, {"paddings": [1, 0, 2, 2], "mode": "edge"},
     ["Out"], 0.0),
    ("crop", "crop", {"X": H32(3, 5, 6)}, {"offsets": [1, 0, 2], "shape": [2, 4, 3]}, ["Out"], 0.0),
    ("huber_loss", "huber_loss", {"X": H32(6, 1) * 2, "Y": H32(6, 1) * 2}, {"delta": 1.0},
     ["Out", "Residual"], 1e-6),
    ("mean_iou", "mean_iou", {"Predictions": np.array([0, 1, 2, 2, 1, 4], np.int32),
                              "Labels": np.array([0, 1, 1, 2, 3, 4], np.int32)},
     {"num_classes": 6, "out_dtypes": {"OutWrong": "int32", "OutCorrect": "int32"}},
     ["OutMeanIou", "OutWrong", "OutCorrect"], 1e-6),
    ("auc", "auc", {"Predict": np.stack([1 - (p := r15.rand(40)), p], 1).astype(np.float32),
                    "Label": (r15.rand(40, 1) > 0.5).astype(np.int64),
                    "StatPos": r15.randint(0, 5, 101).astype(np.int64),
                    "StatNeg": r15.randint(0, 5, 101).astype(np.int64)},
     {"num_thresholds": 100, "out_dtypes": {"StatPosOut": "int64", "StatNegOut": "int64"}},
     ["AUC", "StatPosOut", "StatNegOut"], 1e-6),
    ("deformable_conv", "deformable_conv",
     {"Input": H32(2, 4, 6, 6), "Offset": H32(2, 2 * 2 * 9, 6, 6) * 1.5, "Mask": r15.rand(2, 2 * 9, 6, 6).astype(np.float32),
      "Filter": H32(6, 2, 3, 3)},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1], "groups": 2,
      "deformable_groups": 2}, ["Output"], 1e-5),
    ("deformable_conv_v1", "deformable_conv_v1",
     {"Input": H32(1, 3, 7, 7), "Offset": H32(1, 2 * 9, 3, 3) * 2.0, "Filter": H32(4, 3, 3, 3)},
     {"strides": [2, 2], "paddings": [0, 0], "dilations": [1, 1], "groups": 1,
      "deformable_groups": 1}, ["Output"], 1e-5),
    ("print", "print", {"X": H32(2, 3)}, {"message": "x: ", "first_n": 1}, ["Out"], 0.0),
]


def hold_close(what, want, got, tol=1e-5, per_tensor=False):
    """Index outputs equal, shapes and dtypes too; floats finite where want
    is (and non-finite values equal), within tol of max(1, |want|) element
    by element, or of max(1, max|want|) over the tensor (per_tensor: a
    trained state, whose sums card and CPU, or the two packages, take in
    other orders).  Raises AssertionError; returns the worst share of tol."""
    w, g = np.asarray(want), np.asarray(got)
    if w.shape != g.shape or w.dtype != g.dtype:
        raise AssertionError(f"{what}: {g.shape} {g.dtype} != {w.shape} {w.dtype}")
    if not np.issubdtype(w.dtype, np.floating):
        if not np.array_equal(w, g):
            raise AssertionError(f"{what}: index outputs differ")
        return 0.0
    wf, gf = w.astype(np.float64), g.astype(np.float64)
    if wf.size and not np.array_equal(np.isfinite(wf), np.isfinite(gf)):
        raise AssertionError(f"{what}: card and CPU differ in which values are finite")
    fin = np.isfinite(wf)
    wf, gf = wf[fin], gf[fin]
    if not np.array_equal(np.asarray(w)[~fin], np.asarray(g)[~fin], equal_nan=True):
        raise AssertionError(f"{what}: card and CPU differ in their non-finite values")
    scale = np.maximum(1.0, np.abs(wf).max() if per_tensor and wf.size else np.abs(wf))
    share = float((np.abs(gf - wf) / (tol * scale)).max()) if wf.size else 0.0
    if not share <= 1.0:
        raise AssertionError(f"{what}: card vs CPU off by {share} x the tolerance")
    return share


def _out_names(out_slots):
    names = []
    for spec in out_slots:
        slot, _, n = spec.partition(":")
        names += [(slot, f"out_{slot}{i}") for i in range(int(n))] if n else [(slot, f"out_{slot}")]
    return names


def build_one_op(fluid, op_type, inputs, attrs, out_slots):
    """The one-op program of a case: each input
    a data var, each output a var of attrs' `out_dtype` or per-slot
    `out_dtypes`, no output shapes.  Returns (program, feed, fetch names)."""
    attrs = dict(attrs)
    out_dtypes = attrs.pop("out_dtypes", {})
    prog = fluid.Program()
    feed = {}
    with fluid.program_guard(prog, fluid.Program()):
        block = prog.global_block()
        in_io = {}
        for slot, val in inputs.items():
            vals = val if isinstance(val, list) else [val]
            in_io[slot] = []
            for k, v in enumerate(vals):
                arr = np.asarray(v)
                name = f"in_{slot}" if len(vals) == 1 else f"in_{slot}{k}"
                block.create_var(name, shape=arr.shape, dtype=str(arr.dtype), is_data=True)
                feed[name] = arr
                in_io[slot].append(name)
        out_io = {}
        for slot, name in _out_names(out_slots):
            block.create_var(name, dtype=out_dtypes.get(slot, attrs.get("out_dtype", "float32")))
            out_io.setdefault(slot, []).append(name)
        block.append_op(op_type, inputs=in_io, outputs=out_io, attrs=dict(attrs))
    return prog, feed, [n for _, n in _out_names(out_slots)]


# --- the four detection models of the CPU tests and the card's parity ------
# phase, built in either package: (loss, [outputs]) and a seeded feed each

def _ssd(fluid):
    layers = fluid.layers
    img = layers.data("img", [3, 32, 32], dtype="float32")
    gb = layers.data("gb", [2, 4], dtype="float32")
    gl = layers.data("gl", [2], dtype="int32")
    c1 = layers.conv2d(img, 8, 3, stride=2, padding=1, act="relu")
    c2 = layers.conv2d(c1, 16, 3, stride=2, padding=1, act="relu")
    locs, confs, boxes, variances = layers.multi_box_head(
        [c1, c2], img, base_size=32, num_classes=4, aspect_ratios=[[1.0], [1.0, 2.0]],
        min_sizes=[8.0, 16.0], max_sizes=[16.0, 28.0], clip=True)
    loss = layers.mean(layers.ssd_loss(locs, confs, gb, gl, boxes, variances))
    nmsed = layers.detection_output(locs, confs, boxes, variances, keep_top_k=10)
    return loss, [nmsed]


def _ssd_feed(rng, n=4):
    gt = rng.uniform(0.1, 0.6, (n, 2, 4)).astype("f4")
    gt[:, :, 2:] = gt[:, :, :2] + rng.uniform(0.2, 0.4, (n, 2, 2))
    return {"img": rng.rand(n, 3, 32, 32).astype("f4"), "gb": np.clip(gt, 0, 1),
            "gl": rng.randint(1, 4, (n, 2)).astype("int32")}


def _yolo(fluid):
    layers = fluid.layers
    img = layers.data("img", [3, 32, 32], dtype="float32")
    gb = layers.data("gb", [2, 4], dtype="float32")
    gl = layers.data("gl", [2], dtype="int32")
    c1 = layers.conv2d(img, 16, 3, stride=2, padding=1, act="relu")
    c2 = layers.conv2d(c1, 32, 3, stride=2, padding=1, act="relu")
    head = layers.conv2d(c2, 3 * 8, 3, stride=2, padding=1)
    up = layers.resize_nearest(head, scale=2.0)  # a second scale, as YOLOv3's route
    # nearest_interp has no inference rule in the JAX package: declare the
    # upsampled shape, as Fluid's InferShape would
    up.shape = (-1, 3 * 8, 8, 8)
    head2 = layers.conv2d(layers.concat([up, c2], axis=1), 3 * 8, 1)
    l1 = layers.yolov3_loss(head, gb, gl, YOLO_ANCHORS, [3, 4, 5], 3, ignore_thresh=0.7,
                            downsample_ratio=8)
    l2 = layers.yolov3_loss(head2, gb, gl, YOLO_ANCHORS, [0, 1, 2], 3, ignore_thresh=0.7,
                            downsample_ratio=4)
    loss = layers.mean(l1 + l2)
    size = layers.data("size", [2], dtype="int32")
    boxes, scores = layers.yolo_box(head, size, YOLO_ANCHORS[6:], 3, conf_thresh=0.01,
                                    downsample_ratio=8)
    nmsed = layers.multiclass_nms(boxes, layers.transpose(scores, [0, 2, 1]),
                                  score_threshold=0.01, nms_top_k=20, keep_top_k=10,
                                  nms_threshold=0.45, background_label=-1, normalized=False)
    return loss, [nmsed]


def _yolo_feed(rng, n=4):
    boxes = rng.uniform(0.2, 0.8, (n, 2, 4)).astype("f4")
    boxes[:, :, 2:] = rng.uniform(0.1, 0.5, (n, 2, 2))
    return {"img": rng.rand(n, 3, 32, 32).astype("f4"), "gb": boxes,
            "gl": rng.randint(0, 3, (n, 2)).astype("int32"),
            "size": np.full((n, 2), 32, np.int32)}


def _rcnn(fluid):
    layers = fluid.layers
    feat = layers.data("feat", [4, 16, 16], dtype="float32")
    props = layers.data("props", [12, 4], dtype="float32")
    gcls = layers.data("gcls", [2], dtype="int32")
    gbox = layers.data("gbox", [2, 4], dtype="float32")
    rois, labels, tgt, inw, outw, sw = layers.generate_proposal_labels(
        props, gcls, None, gbox, batch_size_per_im=16, fg_thresh=0.5, class_nums=3,
        use_random=False)
    pooled = layers.roi_pool(feat, layers.reshape(rois, [-1, 4]), 4, 4, spatial_scale=0.25)
    fcin = layers.reshape(pooled, [-1, 4 * 16])
    cls_logits = layers.fc(fcin, 3)
    ce = layers.softmax_with_cross_entropy(cls_logits, layers.cast(layers.reshape(labels, [-1, 1]),
                                                                   "int64"))
    w = layers.reshape(sw, [-1, 1])
    loss = layers.reduce_sum(ce * w) / (layers.reduce_sum(w) + 1.0)
    return loss, [rois, labels]


def _rcnn_feed(rng, n=1):
    props = rng.uniform(0, 40, (n, 12, 4)).astype("f4")
    props[..., 2:] = props[..., :2] + rng.uniform(8, 20, (n, 12, 2))
    return {"feat": rng.rand(n, 4, 16, 16).astype("f4"), "props": props,
            "gcls": np.array([[1, 2]] * n, "int32"),
            "gbox": np.array([[[4, 4, 20, 20], [30, 30, 50, 50]]] * n, "f4")}


def _retina(fluid):
    layers = fluid.layers
    feat = layers.data("feat", [8, 4, 4], dtype="float32")
    av = layers.data("a", [4], dtype="float32")
    gv = layers.data("g", [2, 4], dtype="float32")
    lv = layers.data("gl", [2], dtype="int32")
    cls = layers.transpose(layers.conv2d(feat, 3, 3, padding=1), [0, 2, 3, 1])
    loc = layers.transpose(layers.conv2d(feat, 4, 3, padding=1), [0, 2, 3, 1])
    cls = layers.reshape(cls, [0, -1, 3])
    loc = layers.reshape(loc, [0, -1, 4])
    _, _, label, tgt, inw, fg_num, score_w = layers.retinanet_target_assign(
        loc, cls, av, None, gv, lv, positive_overlap=0.5, negative_overlap=0.4)
    focal = layers.sigmoid_focal_loss(layers.reshape(cls, [-1, 3]),
                                      layers.reshape(label, [-1, 1]),
                                      layers.reduce_sum(layers.cast(fg_num, "float32")))
    reg = layers.reduce_sum(layers.abs(loc - tgt) * inw)
    loss = layers.reduce_sum(focal) + reg
    return loss, [label, fg_num]


def _retina_feed(rng, n=1):
    return {"feat": rng.randn(n, 8, 4, 4).astype("f4"), "a": ANCHOR_GRID,
            "g": np.array([[[6, 6, 26, 26], [40, 40, 60, 60]]] * n, "f4"),
            "gl": np.array([[1, 2]] * n, "int32")}


MODELS = {"ssd": (_ssd, _ssd_feed), "yolov3": (_yolo, _yolo_feed),
          "faster_rcnn_stage2": (_rcnn, _rcnn_feed), "retinanet_head": (_retina, _retina_feed)}
