"""fluid.layers-compatible namespace: the builders of the ported slices."""
from .control_flow import (  # noqa: F401
    While, array_length, array_read, array_write, cond, create_array, equal, greater_than,
    increment, less_than,
)
from .io import data  # noqa: F401
from .learning_rate_scheduler import (  # noqa: F401
    cosine_decay, exponential_decay, inverse_time_decay, linear_lr_warmup, natural_exp_decay,
    noam_decay, piecewise_decay, polynomial_decay,
)
from .metric import accuracy, auc, mean_iou  # noqa: F401
from .detection import (  # noqa: F401
    anchor_generator, bipartite_match, box_clip, box_coder, box_decoder_and_assign,
    collect_fpn_proposals, density_prior_box, detection_map, detection_output,
    distribute_fpn_proposals, generate_mask_labels, generate_proposal_labels, generate_proposals,
    iou_similarity, multi_box_head, multiclass_nms, polygon_box_transform, prior_box, psroi_pool,
    retinanet_detection_output, retinanet_target_assign, roi_align, roi_perspective_transform,
    roi_pool, rpn_target_assign, sigmoid_focal_loss, ssd_loss, target_assign, yolo_box,
    yolov3_loss,
)
from .nn import (  # noqa: F401
    abs,
    argsort,
    batch_norm,
    ceil,
    clip,
    clip_by_norm,
    conv2d,
    conv2d_transpose,
    cos,
    crop,
    cross_entropy,
    cumsum,
    dropout,
    elementwise_add,
    elementwise_div,
    elementwise_max,
    elementwise_min,
    elementwise_mul,
    elementwise_pow,
    elementwise_sub,
    embedding,
    erf,
    exp,
    fc,
    flatten,
    floor,
    fused_attention,
    gather,
    gather_nd,
    gelu,
    group_norm,
    instance_norm,
    l2_normalize,
    label_smooth,
    layer_norm,
    leaky_relu,
    log,
    logsigmoid,
    matmul,
    mean,
    mul,
    one_hot,
    pad2d,
    pool2d,
    pow,
    Print,
    py_func,
    reciprocal,
    reduce_max,
    reduce_mean,
    reduce_min,
    reduce_prod,
    reduce_sum,
    relu,
    relu6,
    reshape,
    resize_bilinear,
    resize_nearest,
    round,
    scale,
    scatter,
    sigmoid,
    sigmoid_cross_entropy_with_logits,
    sin,
    slice,
    softmax,
    softmax_with_cross_entropy,
    softplus,
    softsign,
    space_to_depth,
    split,
    sqrt,
    square,
    square_error_cost,
    squeeze,
    stack,
    tanh,
    topk,
    transpose,
    unsqueeze,
)
from .misc import (  # noqa: F401
    affine_channel, affine_grid, beam_search, beam_search_decode, bpr_loss, chunk_eval, conv3d,
    ctc_greedy_decoder, diag, edit_distance, expand, grid_sampler, hash, hinge_loss, hsigmoid,
    im2sequence, key_padding_bias, kldiv_loss, log_loss, logical_and, logical_not, logical_or, lrn,
    margin_rank_loss, maxout, multiplex, nce, pool3d, rank_loss, reverse, row_conv,
    sampled_softmax_with_cross_entropy, selu, similarity_focus, spectral_norm, tree_conv,
)
from .sequence import (  # noqa: F401
    DynamicRNN, StaticRNN, attention_bias, crf_decoding, dynamic_gru, dynamic_lstm, dynamic_lstmp,
    linear_chain_crf, lstm, position_encoding, sequence_concat, sequence_conv, sequence_enumerate,
    sequence_erase, sequence_expand, sequence_expand_as, sequence_first_step, sequence_last_step,
    sequence_mask, sequence_pad, sequence_pool, sequence_reverse, sequence_scatter, sequence_slice,
    sequence_softmax, sequence_unpad, warpctc,
)
from .tail import (  # noqa: F401
    acos, adaptive_pool2d, adaptive_pool3d, add_position_encoding, asin, atan,
    autoincreased_step_counter, batch, bilinear_tensor_product, brelu, continuous_value_model,
    conv3d_transpose, cos_sim, create_parameter, create_tensor, data_norm, deformable_conv,
    deformable_roi_pooling, dice_loss, double_buffer, elementwise_floordiv, elementwise_mod, elu,
    fill_constant_batch_size_like, fsp_matrix, gaussian_random, gaussian_random_batch_size_like,
    get_tensor_from_selected_rows, greater_equal, gru_unit, hard_shrink, hard_sigmoid, has_inf,
    has_nan, huber_loss, image_resize, image_resize_short, is_empty, isfinite, less_equal, load,
    logical_xor, lstm_unit, merge_selected_rows, not_equal, npair_loss, pad, pad_constant_like,
    pixel_shuffle, prelu, random_crop, range, rank, reduce_all, reduce_any, rsqrt, sampling_id,
    sequence_reshape, shape, shuffle, shuffle_channel, sign, smooth_l1, soft_relu, softshrink,
    stanh, sum, swish, tanh_shrink, teacher_student_sigmoid_loss, temporal_shift,
    thresholded_relu, unfold, uniform_random, uniform_random_batch_size_like, unstack,
)
from .tensor import (  # noqa: F401
    argmax, argmin, assign, cast, concat, create_global_var, fill_constant, linspace, ones, sums,
    zeros, zeros_like,
)
from ..core.dtypes import canonical_dtype  # noqa: F401,E402
from ..core.layer_helper import LayerHelper  # noqa: F401,E402
from ..core.program import Variable  # noqa: F401,E402
from .nn import dropout_prob_check  # noqa: F401,E402


def _dygraph_dispatch(name, graph_fn):
    """Stateless layers work in both modes: inside a `dygraph.guard()` the
    call goes to dygraph/functional.py, outside it to the graph-mode layer."""
    import functools

    @functools.wraps(graph_fn)
    def wrapper(*a, **k):
        from ..dygraph import base as _db

        if _db.enabled():
            from ..dygraph import functional as _F

            return getattr(_F, name)(*a, **k)
        return graph_fn(*a, **k)

    return wrapper


for _n in (
    "mean", "relu", "softmax", "matmul", "reshape", "transpose", "concat",
    "reduce_sum", "reduce_mean", "square_error_cost", "cross_entropy",
    "softmax_with_cross_entropy", "accuracy", "dropout", "sigmoid", "tanh",
    "sqrt", "square", "exp", "log",
):
    globals()[_n] = _dygraph_dispatch(_n, globals()[_n])
del _n
