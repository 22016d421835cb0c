"""Model compression (counterpart of paddle_tpu/contrib/slim): QAT and
post-training quantization with the freeze for int8 deployment
(`quantization`), structured pruning (`prune`) and distillation losses
(`distillation`)."""
from .quantization import quant_aware, post_training_quantize  # noqa: F401
from .distillation import FSPDistiller, L2Distiller, SoftLabelDistiller  # noqa: F401
from .prune import Pruner, StructurePruner, apply_masks, prune_parameters, sparsity  # noqa: F401
