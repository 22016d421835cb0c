"""The port stands alone: paddle_tpu_torch (and chip_smoke.py and the
port's tools) import neither jax nor anything of paddle_tpu."""
import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(p, ROOT)
    for p in glob.glob(os.path.join(ROOT, "paddle_tpu_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"] + sorted(
    os.path.relpath(p, ROOT) for p in glob.glob(os.path.join(ROOT, "tools", "port_*.py")))


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "jax" or top == "jaxlib" or top == "paddle_tpu"


@pytest.mark.parametrize("relpath", PORT_FILES)
def test_no_jax_or_paddle_tpu_import(relpath):
    with open(os.path.join(ROOT, relpath)) as f:
        tree = ast.parse(f.read(), relpath)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{relpath} imports {bad}"


def test_package_imports_with_jax_and_paddle_tpu_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['paddle_tpu'] = None\n"
        "import paddle_tpu_torch as fluid\n"
        "from paddle_tpu_torch import lod\n"
        "from paddle_tpu_torch.layers import control_flow, learning_rate_scheduler, misc, sequence\n"
        "from paddle_tpu_torch.models import nmt\n"
        "from paddle_tpu_torch import errors, monitor, pipeline, parallel\n"
        "from paddle_tpu_torch.monitor import memstats\n"
        "from paddle_tpu_torch.core.registry import registered_ops\n"
        "from paddle_tpu_torch import clip, flags, io\n"
        "from paddle_tpu_torch.core import analysis, passes, regularizer\n"
        "from paddle_tpu_torch.layers import tail, tensor\n"
        "from paddle_tpu_torch.ops import control_flow_ops\n"
        "from paddle_tpu_torch import (checkpoint_manager, dataset, datasets, faults, integrity,\n"
        "                              reader, recordio, recordio_writer, resilience)\n"
        "from paddle_tpu_torch.core import locks\n"
        "from paddle_tpu_torch import dist_resilience, launch\n"
        "from paddle_tpu_torch.serving import fleet, replica_main, router\n"
        "from paddle_tpu_torch.contrib import slim\n"
        "from paddle_tpu_torch.contrib.slim import distillation, prune, quantization\n"
        "assert fluid.contrib.slim is slim and slim.quant_aware is quantization.quant_aware\n"
        "assert {'fake_quantize_abs_max', 'fake_channel_wise_quantize_abs_max',\n"
        "        'fake_quantize_moving_average_abs_max', 'fake_dequantize_max_abs'} <= set(\n"
        "    registered_ops())\n"
        "assert fluid.io.save_quantized_inference_model\n"
        "assert fluid.launch is launch and fluid.dist_resilience is dist_resilience\n"
        "assert fluid.serving.ServingFleet is fleet.ServingFleet and fluid.serving.Router\n"
        "assert {'FLAGS_cudnn_deterministic', 'FLAGS_paddle_num_threads'} <= set(flags._REGISTRY)\n"
        "assert fluid.DataLoader is fluid.PyReader is reader.DataLoader\n"
        "assert fluid.CheckpointManager is checkpoint_manager.CheckpointManager\n"
        "assert fluid.QueueDataset is dataset.QueueDataset and fluid.InMemoryDataset\n"
        "assert fluid.resilient_train_loop is resilience.resilient_train_loop\n"
        "assert fluid.FaultInjector is faults.FaultInjector and fluid.RetryPolicy\n"
        "assert fluid.ResilienceStats and fluid.DataFeeder and fluid.integrity is integrity\n"
        "assert issubclass(errors.LockTimeoutError, errors.FatalError)\n"
        "assert issubclass(errors.StorageError, errors.TrainingError)\n"
        "assert {'FLAGS_feed_validation', 'FLAGS_data_corrupt_budget', 'FLAGS_fault_spec',\n"
        "        'FLAGS_integrity_check_period', 'FLAGS_max_ckpt_lag_steps',\n"
        "        'FLAGS_ckpt_fallback_dir', 'FLAGS_publish_period_steps'} <= set(flags._REGISTRY)\n"
        "assert hasattr(fluid.Executor, 'train_from_dataset')\n"
        "assert locks.named_lock('data.recordio_lib', rank=50).rank == 50\n"
        "assert fluid.analysis is analysis and io.IntegrityError is errors.IntegrityError\n"
        "assert issubclass(analysis.ProgramVerificationError, errors.FatalError)\n"
        "assert {'remove_identity_ops', 'fold_scale_chains', 'prune_dead_ops'} <= set("
        "passes.registered_passes())\n"
        "assert fluid.get_flags('FLAGS_verify_program') == {'FLAGS_verify_program': 'structural'}\n"
        "assert {'sum', 'sqrt', 'sign', 'elementwise_max', 'clip', 'clip_by_norm',\n"
        "        'square_error_cost', 'cross_entropy', 'while'} <= set(registered_ops())\n"
        "assert fluid.CompiledProgram is parallel.CompiledProgram\n"
        "assert {'fused_attention', 'batch_norm', 'conv2d', 'momentum'} <= set(registered_ops())\n"
        "assert {'attention_bias', 'position_encoding', 'sequence_pool', 'sequence_mask',\n"
        "        'one_hot', 'label_smooth', 'pow', 'elementwise_min', 'elementwise_div',\n"
        "        'increment', 'assign_value', 'less_than', 'logical_and', 'expand',\n"
        "        'key_padding_bias', 'beam_search', 'beam_search_decode'} <= set(registered_ops())\n"
        "assert not [m for m in sys.modules if m.startswith(('jax', 'paddle_tpu.'))"
        " and sys.modules[m] is not None]\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("src", ["ln_residual.cu", "bias_act.cu", "flash_attention.cu",
                                 "softmax_xent.cu", "adam.cu", "bn_epilogue.cu"])
def test_kernel_source_names_what_it_replaces(src):
    """Every CUDA source opens with the TPU kernel it replaces and its bound."""
    with open(os.path.join(ROOT, "paddle_tpu_torch", "csrc", src)) as f:
        head = f.read(3000)
    assert "Replaces: paddle_tpu/ops/pallas_" in head
    assert "Bound on the H100" in head
