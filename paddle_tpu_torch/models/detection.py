"""The two detection models Fluid users ran most, built from the layers of
layers/detection.py: MobileNet-v1 SSD (PaddlePaddle/models
PaddleCV/object_detection/mobilenet_ssd.py) and YOLOv3 on DarkNet-53
(PaddlePaddle/models PaddleCV/yolov3/models/{darknet,yolov3}.py), with a
seeded batch of synthetic ground truth for each.

Ground truth is padded to `max_boxes` a image: SSD takes corner boxes
[N, B, 4] in [0, 1] with labels in 1..C-1 (0 is the background) and
`gt_lengths` [N]; YOLOv3 takes center boxes (x, y, w, h) in [0, 1] with
labels in 0..C-1 and zero rows as padding (yolov3_loss skips a box whose
width or height is 0)."""
from __future__ import annotations

import numpy as np

from .. import layers, optimizer
from ..core.initializer import ConstantInitializer, NormalInitializer
from ..core.param_attr import ParamAttr
from ..core.program import Program, program_guard
from ..core.regularizer import L2Decay

# --- MobileNet-v1 SSD (PaddleCV/object_detection/mobilenet_ssd.py) ---------

SSD_ASPECT_RATIOS = [[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0]]
SSD_STEPS = [8, 16, 32, 64, 100, 300]


def _conv_bn(x, filter_size, num_filters, stride, padding, num_groups=1, act="relu"):
    """conv (no bias) + batch norm + act; a depthwise conv is
    conv2d(groups=channels)."""
    conv = layers.conv2d(x, num_filters, filter_size, stride=stride, padding=padding,
                         groups=num_groups, bias_attr=False)
    return layers.batch_norm(conv, act=act)


def _depthwise_separable(x, nf1, nf2, groups, stride, scale):
    dw = _conv_bn(x, 3, int(nf1 * scale), stride, 1, num_groups=int(groups * scale))
    return _conv_bn(dw, 1, int(nf2 * scale), 1, 0)


def _extra_block(x, nf1, nf2, stride, scale):
    pw = _conv_bn(x, 1, int(nf1 * scale), 1, 0)
    return _conv_bn(pw, 3, int(nf2 * scale), stride, 1)


def mobilenet_ssd(img, num_classes, scale=1.0):
    """The SSD heads over MobileNet-v1: conv11 (19 x 19 at 300 x 300), conv13
    (10 x 10) and four extra blocks (5, 3, 2, 1); returns multi_box_head's
    (locs, confs, boxes, variances)."""
    x = _conv_bn(img, 3, int(32 * scale), 2, 1)
    for nf1, nf2, groups, stride in ((32, 64, 32, 1), (64, 128, 64, 2), (128, 128, 128, 1),
                                     (128, 256, 128, 2), (256, 256, 256, 1), (256, 512, 256, 2)):
        x = _depthwise_separable(x, nf1, nf2, groups, stride, scale)
    for _ in range(5):
        x = _depthwise_separable(x, 512, 512, 512, 1, scale)
    module11 = x
    x = _depthwise_separable(x, 512, 1024, 512, 2, scale)
    module13 = _depthwise_separable(x, 1024, 1024, 1024, 1, scale)
    module14 = _extra_block(module13, 256, 512, 2, scale)
    module15 = _extra_block(module14, 128, 256, 2, scale)
    module16 = _extra_block(module15, 128, 256, 2, scale)
    module17 = _extra_block(module16, 64, 128, 2, scale)
    return layers.multi_box_head(
        [module11, module13, module14, module15, module16, module17], img,
        base_size=int(img.shape[2]), num_classes=num_classes, aspect_ratios=SSD_ASPECT_RATIOS,
        min_ratio=20, max_ratio=90, steps=SSD_STEPS, kernel_size=3, pad=1, flip=True)


def build_mobilenet_ssd(num_classes=21, image_size=300, max_boxes=50, learning_rate=1e-3,
                        with_optimizer=True, scale=1.0, nms_threshold=0.45):
    """(main, startup, feeds, fetches): ssd_loss with gt_lengths, RMSProp
    (with_optimizer); `fetches["detections"]` is detection_output's
    [N, keep_top_k, 6] (the same heads, for serving)."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", [3, image_size, image_size], dtype="float32")
        gt_box = layers.data("gt_box", [max_boxes, 4], dtype="float32")
        gt_label = layers.data("gt_label", [max_boxes], dtype="int32")
        gt_len = layers.data("gt_len", [], dtype="int32")
        locs, confs, boxes, variances = mobilenet_ssd(img, num_classes, scale)
        loss = layers.mean(layers.ssd_loss(locs, confs, gt_box, gt_label, boxes, variances,
                                           gt_lengths=gt_len))
        detections = layers.detection_output(locs, confs, boxes, variances,
                                             nms_threshold=nms_threshold)
        if with_optimizer:
            optimizer.RMSProp(learning_rate).minimize(loss)
    feeds = {"img": img, "gt_box": gt_box, "gt_label": gt_label, "gt_len": gt_len}
    return main, startup, feeds, {"loss": loss, "detections": detections, "locs": locs,
                                  "confs": confs}


def make_ssd_batch(batch, image_size=300, num_classes=21, max_boxes=50, min_boxes=1,
                   most_boxes=20, rng=None):
    """Images in [0, 1), 1-20 corner boxes an image (labels 1..C-1), padded
    to max_boxes with zero rows."""
    rng = rng or np.random.RandomState(0)
    lens = rng.randint(min_boxes, most_boxes + 1, batch).astype(np.int32)
    box = np.zeros((batch, max_boxes, 4), np.float32)
    label = np.zeros((batch, max_boxes), np.int32)
    for i, n in enumerate(lens):
        xy = rng.uniform(0.0, 0.7, (n, 2))
        wh = rng.uniform(0.05, 0.3, (n, 2))
        box[i, :n] = np.concatenate([xy, np.minimum(xy + wh, 1.0)], 1)
        label[i, :n] = rng.randint(1, num_classes, n)
    return {"img": rng.rand(batch, 3, image_size, image_size).astype(np.float32),
            "gt_box": box, "gt_label": label, "gt_len": lens}


# --- YOLOv3 on DarkNet-53 (PaddleCV/yolov3/models/{darknet,yolov3}.py) -----

YOLO_ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90, 156, 198, 373, 326]
YOLO_ANCHOR_MASKS = [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
DARKNET53_STAGES = [1, 2, 8, 8, 4]


def _conv_bn_leaky(x, ch_out, filter_size, stride, padding, act="leaky"):
    """conv (no bias, N(0, 0.02)) + batch norm (scale N(0, 0.02), offset 0,
    neither decayed) + leaky ReLU 0.1."""
    conv = layers.conv2d(x, ch_out, filter_size, stride=stride, padding=padding,
                         param_attr=ParamAttr(initializer=NormalInitializer(0.0, 0.02)),
                         bias_attr=False)
    out = layers.batch_norm(
        conv, param_attr=ParamAttr(initializer=NormalInitializer(0.0, 0.02),
                                   regularizer=L2Decay(0.0)),
        bias_attr=ParamAttr(initializer=ConstantInitializer(0.0), regularizer=L2Decay(0.0)))
    return layers.leaky_relu(out, alpha=0.1) if act == "leaky" else out


def darknet53(img, stages=DARKNET53_STAGES):
    """DarkNet-53's body; returns the last three stages' outputs, deepest
    first (strides 32, 16, 8)."""
    x = _conv_bn_leaky(img, 32, 3, 1, 1)
    x = _conv_bn_leaky(x, 64, 3, 2, 1)
    blocks = []
    for i, count in enumerate(stages):
        ch = 32 * 2 ** i
        for _ in range(count):
            y = _conv_bn_leaky(x, ch, 1, 1, 0)
            y = _conv_bn_leaky(y, ch * 2, 3, 1, 1)
            x = layers.elementwise_add(x, y)
        blocks.append(x)
        if i < len(stages) - 1:
            x = _conv_bn_leaky(x, ch * 4, 3, 2, 1)
    return blocks[-1:-4:-1]


def _detection_block(x, channel):
    for _ in range(2):
        x = _conv_bn_leaky(x, channel, 1, 1, 0)
        x = _conv_bn_leaky(x, channel * 2, 3, 1, 1)
    route = _conv_bn_leaky(x, channel, 1, 1, 0)
    return route, _conv_bn_leaky(route, channel * 2, 3, 1, 1)


def _upsample(x, scale=2):
    """resize_nearest by `scale`; nearest_interp has no inference rule (as in
    the JAX package), so the output's shape is declared here, as Fluid's
    InferShape would give it."""
    out = layers.resize_nearest(x, scale=float(scale))
    out.shape = (x.shape[0], x.shape[1], x.shape[2] * scale, x.shape[3] * scale)
    return out


def yolov3_heads(img, num_classes, anchor_masks=YOLO_ANCHOR_MASKS, stages=DARKNET53_STAGES):
    """The three YOLOv3 output maps over DarkNet-53, deepest first."""
    outputs = []
    route = None
    for i, block in enumerate(darknet53(img, stages)):
        if i > 0:
            block = layers.concat([route, block], axis=1)
        route, tip = _detection_block(block, 512 // 2 ** i)
        outputs.append(layers.conv2d(
            tip, len(anchor_masks[i]) * (num_classes + 5), 1,
            param_attr=ParamAttr(initializer=NormalInitializer(0.0, 0.02)),
            bias_attr=ParamAttr(initializer=ConstantInitializer(0.0), regularizer=L2Decay(0.0))))
        if i < 2:
            route = _upsample(_conv_bn_leaky(route, 256 // 2 ** i, 1, 1, 0))
    return outputs


def build_yolov3(num_classes=80, image_size=608, max_boxes=50, learning_rate=1e-3, momentum=0.9,
                 weight_decay=5e-4, with_optimizer=True, ignore_thresh=0.7, label_smooth=True,
                 anchors=YOLO_ANCHORS, anchor_masks=YOLO_ANCHOR_MASKS, stages=DARKNET53_STAGES,
                 conf_thresh=0.005, nms_top_k=1000, keep_top_k=100, nms_threshold=0.45):
    """(main, startup, feeds, fetches): the sum over the three scales of the
    batch mean of yolov3_loss, Momentum with L2Decay (with_optimizer);
    `fetches["detections"]` is yolo_box of each scale + multiclass_nms,
    [N, keep_top_k, 6]."""
    main, startup = Program(), Program()
    with program_guard(main, startup):
        img = layers.data("img", [3, image_size, image_size], dtype="float32")
        gt_box = layers.data("gt_box", [max_boxes, 4], dtype="float32")
        gt_label = layers.data("gt_label", [max_boxes], dtype="int32")
        im_size = layers.data("im_size", [2], dtype="int32")
        outputs = yolov3_heads(img, num_classes, anchor_masks, stages)
        losses, boxes, scores = [], [], []
        downsample = 32
        for out, mask in zip(outputs, anchor_masks):
            losses.append(layers.reduce_mean(layers.yolov3_loss(
                out, gt_box, gt_label, anchors, mask, num_classes, ignore_thresh, downsample,
                use_label_smooth=label_smooth)))
            mask_anchors = [a for m in mask for a in anchors[2 * m:2 * m + 2]]
            b, s = layers.yolo_box(out, im_size, mask_anchors, num_classes,
                                   conf_thresh=conf_thresh, downsample_ratio=downsample)
            boxes.append(b)
            scores.append(layers.transpose(s, [0, 2, 1]))
            downsample //= 2
        loss = layers.sums(losses)
        detections = layers.multiclass_nms(
            layers.concat(boxes, axis=1), layers.concat(scores, axis=2),
            score_threshold=conf_thresh, nms_top_k=nms_top_k, keep_top_k=keep_top_k,
            nms_threshold=nms_threshold, background_label=-1, normalized=False)
        if with_optimizer:
            optimizer.Momentum(learning_rate, momentum,
                               regularization=L2Decay(weight_decay)).minimize(loss)
    feeds = {"img": img, "gt_box": gt_box, "gt_label": gt_label, "im_size": im_size}
    return main, startup, feeds, {"loss": loss, "detections": detections}


def make_yolo_batch(batch, image_size=608, num_classes=80, max_boxes=50, min_boxes=1,
                    most_boxes=20, rng=None):
    """Images in [0, 1), 1-20 center boxes an image (labels 0..C-1), zero
    rows as padding, and each image's size."""
    rng = rng or np.random.RandomState(0)
    box = np.zeros((batch, max_boxes, 4), np.float32)
    label = np.zeros((batch, max_boxes), np.int32)
    for i in range(batch):
        n = rng.randint(min_boxes, most_boxes + 1)
        box[i, :n, :2] = rng.uniform(0.1, 0.9, (n, 2))
        box[i, :n, 2:] = rng.uniform(0.03, 0.5, (n, 2))
        label[i, :n] = rng.randint(0, num_classes, n)
    return {"img": rng.rand(batch, 3, image_size, image_size).astype(np.float32),
            "gt_box": box, "gt_label": label,
            "im_size": np.full((batch, 2), image_size, np.int32)}
