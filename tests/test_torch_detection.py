"""The detection family (ops/detection_ops.py, layers/detection.py) on the
CPU against the JAX package.

Every one of the 28 ops of paddle_tpu/ops/detection_ops.py runs as a one-op
program in both packages (tests/test_torch_ops.py's harness) on numpy
inputs from a seed: float outputs within 1e-5 of max(1, |JAX|), index,
label and count outputs equal.  The differentiable ones' gradients are held
against the JAX package's (jax.vjp through its append_backward) within
1e-5 * (1 + max|JAX|).  NMS is held with tied scores (ids and order
included); yolov3_loss with two ground truths in one cell and with padding
ground truths; the random samplers by their rules.  The tiny SSD, the
YOLOv3 head, the Faster R-CNN second stage and the RetinaNet head are built
in both packages (the same `to_dict`), started from the JAX package's
state, and trained 3 Momentum steps: losses, outputs and every
persistable, dtypes included, within 1e-5 of max(1, the tensor's largest
magnitude).  (Momentum, not the JAX tests'
Adam: Adam's first step is lr * g / |g|, which at a gradient that is 0 to
rounding takes either sign in the two packages.)"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as j_unique
from paddle_tpu_torch.core import unique_name as t_unique
from paddle_tpu_torch.models import detection_cases as _cases
from paddle_tpu_torch.ops import cuda_kernels as ck
from test_torch_ops import _grads, _out_names, _run

PKGS = {"jax": (jfluid, j_unique), "torch": (tfluid, t_unique)}
@pytest.fixture(autouse=True)
def launches_unchanged():
    before = dict(ck.LAUNCHES)
    yield
    assert ck.LAUNCHES == before, "a CPU run must not count a kernel launch"


def _hold(want, got, what, per_tensor=False):
    _cases.hold_close(what, want, got, 1e-5, per_tensor)


DETECTION_CASES = _cases.DETECTION_CASES
FWD_CASES = DETECTION_CASES
YOLO_ANCHORS = _cases.YOLO_ANCHORS
ANCHOR_GRID = _cases.ANCHOR_GRID
F, _boxes = _cases.F, _cases._boxes

DETECTION_OPS = (
    "prior_box iou_similarity box_coder yolo_box multiclass_nms roi_align sigmoid_focal_loss "
    "anchor_generator box_clip density_prior_box yolov3_loss roi_pool bipartite_match "
    "target_assign rpn_target_assign generate_proposals detection_map ssd_loss psroi_pool "
    "retinanet_target_assign generate_proposal_labels distribute_fpn_proposals "
    "collect_fpn_proposals box_decoder_and_assign polygon_box_transform "
    "roi_perspective_transform deformable_psroi_pooling generate_mask_labels").split()


def test_every_detection_op_is_registered_and_held():
    """All 28 ops of paddle_tpu/ops/detection_ops.py have a lowering in the
    port and a forward case here."""
    import paddle_tpu.ops.detection_ops as jdet
    from paddle_tpu_torch.core.registry import registered_ops

    src = open(jdet.__file__).read()
    jax_ops = sorted(set(__import__("re").findall(r'@register_op\("(\w+)"\)', src)))
    assert sorted(DETECTION_OPS) == jax_ops and len(jax_ops) == 28
    assert set(jax_ops) <= set(registered_ops())
    assert set(jax_ops) == {c[1] for c in FWD_CASES}


@pytest.mark.parametrize("case", FWD_CASES, ids=[c[0] for c in FWD_CASES])
def test_detection_op_matches_jax(case):
    _, op_type, inputs, attrs, out_slots = case
    want = _run(jfluid, op_type, inputs, attrs, out_slots)
    got = _run(tfluid, op_type, inputs, attrs, out_slots)
    for (slot, _), w, g in zip(_out_names(out_slots), want, got):
        _hold(w, g, f"{op_type} {slot}")


GRAD_CASES = [
    ("roi_align", 0, ["X"]), ("roi_align_adaptive", 0, ["X"]), ("roi_pool", 0, ["X"]),
    ("psroi_pool", 0, ["X"]), ("deformable_psroi_pooling", 0, ["Input", "Trans"]),
    ("deformable_psroi_pooling_no_trans", 0, ["Input"]), ("sigmoid_focal_loss", 0, ["X"]),
    ("yolov3_loss", 0, ["X"]), ("ssd_loss", 0, ["Location", "Confidence"]),
    ("box_coder_decode_batched", 0, ["TargetBox"]), ("yolo_box", 0, ["X"]),
    ("roi_perspective_transform", 0, ["X"]), ("iou_similarity", 0, ["X", "Y"]),
]


@pytest.mark.parametrize("name,_,wrt", GRAD_CASES, ids=[c[0] for c in GRAD_CASES])
def test_detection_gradient_matches_jax(name, _, wrt):
    """d/d(wrt) of sum_k mean(out_k * w_k) over the float outputs, against
    the JAX package's vjp."""
    _, op_type, inputs, attrs, out_slots = next(c for c in FWD_CASES if c[0] == name)
    outs = _run(jfluid, op_type, inputs, attrs, out_slots)
    keep = [i for i, o in enumerate(outs) if np.asarray(o).dtype == np.float32]
    slots = [out_slots[i] for i in keep]
    wr = np.random.RandomState(1)
    weights = [wr.randn(*np.shape(outs[i])).astype(np.float32) for i in keep]
    want = _grads(jfluid, op_type, inputs, attrs, slots, wrt, weights)
    got = _grads(tfluid, op_type, inputs, attrs, slots, wrt, weights)
    for slot, w, g in zip(wrt, want, got):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape, (slot, g.shape, w.shape)
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=0,
                                   atol=1e-5 * (1 + np.abs(w).max()), err_msg=f"{op_type} {slot}")


def test_nms_with_ties_keeps_the_jax_order():
    """Equal scores everywhere: jnp.argsort is stable, so the kept boxes and
    their order are those of the lowest indices; the port's sorts are
    stable too (never torch.topk).  Boxes that overlap exactly suppress the
    later one."""
    boxes = np.tile(_boxes(1, 12), (2, 1, 1))
    boxes[:, 6:] = boxes[:, :6]
    scores = np.full((2, 3, 12), 0.5, np.float32)
    scores[1, 2, ::3] = 0.7
    attrs = {"score_threshold": 0.1, "nms_top_k": 12, "keep_top_k": 20, "nms_threshold": 0.4}
    want = _run(jfluid, "multiclass_nms", {"BBoxes": boxes, "Scores": scores}, attrs, ["Out"])[0]
    got = _run(tfluid, "multiclass_nms", {"BBoxes": boxes, "Scores": scores}, attrs, ["Out"])[0]
    _hold(want, got, "nms ties")
    kept = got[0][got[0][:, 0] >= 0]
    assert len(kept) <= 12 and (kept[:, 1] == 0.5).all()


def _yolo_run(fluid, x, gt_box, gt_label, gt_score=None):
    inputs = {"X": x, "GTBox": gt_box, "GTLabel": gt_label}
    if gt_score is not None:
        inputs["GTScore"] = gt_score
    attrs = {"anchors": YOLO_ANCHORS, "anchor_mask": [0, 1, 2], "class_num": 2,
             "ignore_thresh": 0.7, "downsample_ratio": 8, "out_dtypes": {"GTMatchMask": "int32"}}
    return _run(fluid, "yolov3_loss", inputs, attrs, ["Loss", "ObjectnessMask", "GTMatchMask"])


def test_yolov3_two_ground_truths_in_one_cell():
    """Two ground truths that match one anchor of one cell: the JAX
    package's CPU scatter writes them in gt order, so the later one's score
    is the cell's objectness; the port resolves the duplicate explicitly."""
    x = F(1, 3 * 7, 4, 4) * 0.3
    gt = np.zeros((1, 3, 4), np.float32)
    gt[0, 0] = [0.30, 0.30, 10 / 32.0, 13 / 32.0]
    gt[0, 1] = [0.32, 0.28, 10.5 / 32.0, 12.5 / 32.0]  # same cell (1, 1), same anchor 0
    gt[0, 2] = [0.80, 0.60, 30 / 32.0, 60 / 32.0]
    score = np.array([[0.6, 0.9, 0.8]], np.float32)
    want = _yolo_run(jfluid, x, gt, np.array([[0, 1, 1]], np.int32), score)
    got = _yolo_run(tfluid, x, gt, np.array([[0, 1, 1]], np.int32), score)
    for w, g, what in zip(want, got, ("loss", "objectness", "match")):
        _hold(w, g, what)
    assert np.asarray(got[2])[0, :2].tolist() == [0, 0]
    assert abs(float(np.asarray(got[1])[0, 0, 1, 1]) - 0.9) < 1e-6


def test_yolov3_padding_ground_truths_do_not_clobber():
    """tests/test_detection_train.py:477 in both packages: zero padding rows
    scatter nothing over a real ground truth at cell (0, 0), anchor 0."""
    x = F(1, 3 * 7, 4, 4) * 0.3
    gt = np.zeros((1, 2, 4), np.float32)
    gt[0, 0] = [0.1, 0.1, 10 / 32.0, 13 / 32.0]
    lab = np.zeros((1, 2), np.int32)
    want, got = _yolo_run(jfluid, x, gt, lab), _yolo_run(tfluid, x, gt, lab)
    for w, g, what in zip(want, got, ("loss", "objectness", "match")):
        _hold(w, g, what)
    assert float(np.asarray(got[1])[0, 0, 0, 0]) == 1.0
    assert np.asarray(got[2]).tolist() == [[0, -1]]


def _sample(fluid, op_type, inputs, attrs, slots, seed):
    prog, feed = __import__("test_torch_ops")._build(fluid, op_type, inputs, attrs, slots)
    prog.random_seed = seed
    names = [n for _, n in _out_names(slots)]
    return fluid.Executor(fluid.CPUPlace()).run(prog, feed=feed, fetch_list=names,
                                                scope=fluid.Scope())


def test_rpn_target_assign_random_by_its_rules():
    """use_random draws other numbers than the JAX package's PRNG; held by
    the rules (tests/test_detection_train.py:316-372): at most
    rpn_fg_fraction * batch foregrounds, at most batch sampled, foregrounds
    and backgrounds drawn from the deterministic run's candidates, the same
    counts as the JAX package's, and the same draw for one seed."""
    _, op_type, inputs, attrs, slots = next(c for c in FWD_CASES if c[0] == "rpn_target_assign")
    attrs = dict(attrs, use_random=True, rpn_batch_size_per_im=6, rpn_fg_fraction=0.5)
    det = _run(tfluid, op_type, inputs, dict(attrs, use_random=False, rpn_batch_size_per_im=64),
               slots)
    a = _sample(tfluid, op_type, inputs, attrs, slots, 3)
    b = _sample(tfluid, op_type, inputs, attrs, slots, 3)
    j = _sample(jfluid, op_type, inputs, attrs, slots, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    label, score_w = a[0], a[1]
    fg_all, sampled_all = det[0] == 1, det[1] == 1
    assert (label.sum(1) <= 3).all() and (score_w.sum(1) <= 6).all()
    assert ((label == 1) <= fg_all).all() and ((score_w == 1) <= sampled_all).all()
    np.testing.assert_array_equal(label.sum(1), np.asarray(j[0]).sum(1))
    np.testing.assert_array_equal(score_w.sum(1), np.asarray(j[1]).sum(1))
    assert (a[3][label == 1] == 1).all() and (a[3][label == 0] == 0).all()


def test_generate_proposal_labels_random_by_its_rules():
    """use_random: exactly batch_size_per_im rows, at most fg_fraction of
    them foreground, drawn rows first, the JAX package's counts of drawn
    and foreground rows, and one seed one draw."""
    _, op_type, inputs, attrs, slots = next(c for c in FWD_CASES
                                            if c[0] == "generate_proposal_labels")
    attrs = dict(attrs, use_random=True, fg_thresh=0.3)
    a = _sample(tfluid, op_type, inputs, attrs, slots, 5)
    b = _sample(tfluid, op_type, inputs, attrs, slots, 5)
    j = _sample(jfluid, op_type, inputs, attrs, slots, 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    labels, sw = a[1], a[5]
    assert labels.shape == (2, 8) and ((labels > 0).sum(1) <= 2).all()
    np.testing.assert_array_equal((labels > 0).sum(1), (np.asarray(j[1]) > 0).sum(1))
    np.testing.assert_array_equal(sw.sum(1), np.asarray(j[5]).sum(1))
    for row in sw:  # drawn rows packed first
        assert (np.diff(row) <= 0).all()


MODELS = _cases.MODELS


def _build(fluid, unique, name):
    main, startup = fluid.Program(), fluid.Program()
    with unique.guard(), fluid.program_guard(main, startup):
        loss, extra = MODELS[name][0](fluid)
        fluid.optimizer.Momentum(0.01, 0.9).minimize(loss)
    main.random_seed = startup.random_seed = 3
    return main, startup, loss, extra


@pytest.mark.parametrize("name", list(MODELS))
def test_detection_model_trains_as_in_the_jax_package(name):
    """The same program in both packages; from the JAX package's startup
    state, 3 Momentum steps give the same losses and outputs and the same
    persistables, dtypes included.  The JAX package's program through
    to_dict / from_dict trains the same in the port."""
    built = {k: _build(f, u, name) for k, (f, u) in PKGS.items()}
    (jm, js, jl, jx), (tm, _, tl, tx) = built["jax"], built["torch"]
    assert tm.to_dict() == jm.to_dict()
    assert built["torch"][1].to_dict() == js.to_dict()
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    names = sorted(v.name for v in jm.list_vars() if v.persistable)
    state = {n: np.asarray(jscope.find_var(n)).copy() for n in names}
    for prog in (tm, tfluid.Program.from_dict(jm.to_dict())):
        tscope = tfluid.Scope()
        tfluid.io.load_numpy_params(tscope, state)
        texe = tfluid.Executor(tfluid.CPUPlace())
        jscope2 = jfluid.Scope()
        for n, v in state.items():
            jscope2.set_var(n, v)
        rng = np.random.RandomState(0)
        for step in range(3):
            feed = MODELS[name][1](rng)
            fetch = [jl.name] + [v.name for v in jx]
            want = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope2)
            got = texe.run(prog, feed=feed, fetch_list=fetch, scope=tscope)
            for n, w, g in zip(fetch, want, got):
                _hold(w, g, f"{name} step {step} {n}", per_tensor=True)
        for n in names:
            _hold(np.asarray(jscope2.find_var(n)), tscope.to_numpy(n), f"{name} {n}",
                  per_tensor=True)
