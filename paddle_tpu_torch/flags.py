"""Typed flag registry with FLAGS_* environment passthrough (counterpart of
paddle_tpu/flags.py), holding the flags this port reads so far.  The JAX
package defines 39; each of the others arrives with the module that reads
it.  Types and defaults are the JAX package's."""
from __future__ import annotations

import os
from typing import Any, Dict, List

_REGISTRY: Dict[str, dict] = {}


def _define(name: str, typ, default, help: str):
    value = default
    if name in os.environ:
        value = _coerce(typ, os.environ[name])
    _REGISTRY[name] = {"type": typ, "value": value, "default": default, "help": help}


def DEFINE_bool(name, default, help=""):
    _define(name, bool, default, help)


def DEFINE_int(name, default, help=""):
    _define(name, int, default, help)


def DEFINE_float(name, default, help=""):
    _define(name, float, default, help)


def DEFINE_string(name, default, help=""):
    _define(name, str, default, help)


def _coerce(typ, v):
    if typ is bool and isinstance(v, str):
        return v.lower() in ("1", "true", "yes", "on")
    return typ(v)


def set_flags(flags: Dict[str, Any]):
    for k, v in flags.items():
        if k not in _REGISTRY:
            raise KeyError(f"unknown flag {k!r}; known: {sorted(_REGISTRY)}")
        _REGISTRY[k]["value"] = _coerce(_REGISTRY[k]["type"], v)
        if k in ("FLAGS_lock_telemetry", "FLAGS_lock_timeout_s"):
            from .core import locks as _locks

            _locks.refresh_from_flags()


def get_flags(names) -> Dict[str, Any]:
    if isinstance(names, str):
        names = [names]
    return {n: _REGISTRY[n]["value"] for n in names}


def flag(name: str):
    return _REGISTRY[name]["value"]


def all_flags() -> List[str]:
    return sorted(_REGISTRY)


def init_from_env():
    """Seed every registered flag from its FLAGS_* environment variable
    (a flag defined later reads it when it is defined)."""
    for name, ent in _REGISTRY.items():
        if name in os.environ:
            ent["value"] = _coerce(ent["type"], os.environ[name])


_define("FLAGS_check_nan_inf", bool, False,
        "after each run, scan fetched values for NaN/Inf and raise")
_define("FLAGS_integrity_verify_load", bool, True,
        "verify the sha256 + byte-length stamps of a model directory's manifest "
        "whenever it is loaded")
_define("FLAGS_executor_cache_capacity", int, 128,
        "LRU capacity of the executor's plan cache (program x feed signature x "
        "fetch list); an evicted plan drops its CUDA graph and static buffers")
_define("FLAGS_verify_program", str, "structural",
        "static-analysis level applied to programs before they run "
        "(core/analysis.py): 'off' trusts the builder (and turns off the "
        "append_op-time shape/dtype inference), 'structural' (default) runs "
        "the program verifier (def-before-use, dangling vars, unregistered "
        "ops, orphan sub-blocks, duplicate parameter writes, feed/fetch "
        "targets) on every executor plan-cache miss and after every "
        "registered pass, 'full' adds whole-program shape/dtype re-inference "
        "and the hazard lints (donation, recompile, RNG determinism).  "
        "Error-severity findings raise ProgramVerificationError naming the "
        "op, var and block")
_define("FLAGS_resource_precheck", str, "on",
        "static out-of-memory pre-check on every executor plan-cache miss "
        "(core/resource_plan.py): 'on' (default) plans the program's "
        "liveness-based peak device memory and raises a ResourceError naming "
        "the watermark ops when the plan exceeds the limit, before the plan is "
        "built or the card's allocator is asked for anything; 'off' skips "
        "planning.  The limit is FLAGS_resource_hbm_limit_mb when set, else the "
        "CUDA device's total memory (torch.cuda.mem_get_info); on the CPU, "
        "which has no limit, the check does nothing")
_define("FLAGS_resource_hbm_limit_mb", float, 0.0,
        "device memory limit (MB) the resource pre-check plans against; 0 "
        "(default) takes the CUDA device's total memory.  Set it to plan for "
        "another card than the one attached, or to exercise the over-budget "
        "path")
_define("FLAGS_feed_validation", str, "shape",
        "feed-boundary validation at DataLoader / DataFeeder (reader.py FeedSpec): "
        "'off' trusts the caller, 'shape' (default) checks dtype kind and shape "
        "against the feed vars and raises DataError naming the slot before "
        "lowering, 'full' also scans floating feeds for NaN/Inf")
_define("FLAGS_data_corrupt_budget", int, 0,
        "corrupt or truncated RecordIO chunks one run may skip before the data "
        "layer aborts with a DataError (recordio.py; the data.corrupt_chunks "
        "counter counts them).  0 (default): the first corrupt chunk raises "
        "IOError")
_define("FLAGS_fault_spec", str, "",
        "deterministic fault-injection schedule for the resilience layer "
        "(faults.py), e.g. 'bad_batch@2;nan@5;device@7:RESOURCE_EXHAUSTED;"
        "preempt@11'; each resilient_train_loop call builds one injector from "
        "it, and every entry fires once.  Empty (default) injects nothing")
_define("FLAGS_integrity_check_period", int, 0,
        "live content digests of the training state (integrity.py): every "
        "PERIOD steps the persistables are digested, 1/PERIOD of them a step.  "
        "0 (default) digests nothing")
_define("FLAGS_ckpt_fallback_dir", str, "",
        "second checkpoint root (another filesystem) tried when a save to the "
        "primary fails its storage retries or hits EROFS / EACCES "
        "(checkpoint_manager.py); restore walks both.  Empty (default): none")
_define("FLAGS_max_ckpt_lag_steps", int, 0,
        "degraded-mode bound (checkpoint_manager.py): steps training may run "
        "past its last committed checkpoint while storage fails before a save "
        "raises a terminal StorageError.  0 (default): unbounded")
_define("FLAGS_publish_period_steps", int, 0,
        "resilient_train_loop calls its publish hook every N steps "
        "(resilience.py); a failed publish is counted and training goes on.  "
        "0 (default): no publish hook")
_define("FLAGS_dist_heartbeat_interval_s", float, 0.5,
        "seconds between liveness beats each worker of a gang publishes to its "
        "peers (the gang's health layer, ROADMAP A10.2; kept with the JAX "
        "package's default)")
_define("FLAGS_dist_heartbeat_miss_factor", float, 10.0,
        "a peer is declared dead after interval_s * miss_factor seconds without "
        "an observed beat (the gang's health layer, ROADMAP A10.2)")
_define("FLAGS_dist_straggler_lag_steps", float, 1.0,
        "live straggler detection: a rank whose step count lags the gang by at "
        "least this many steps across 3 beats is named a straggler (the gang's "
        "health layer, ROADMAP A10.2)")
_define("FLAGS_dist_watchdog_timeout_s", float, 120.0,
        "deadline armed around every collective of a gang when its health "
        "layer is active (ROADMAP A10.2); on expiry CollectiveTimeoutError")
_define("FLAGS_dist_bootstrap_timeout_s", float, 120.0,
        "deadline on parallel.distributed.init_distributed's rendezvous (the "
        "gen_nccl_id role): a gang whose worker never dials in raises "
        "CollectiveTimeoutError instead of blocking the others at startup")
_define("FLAGS_dp_bucket_mb", float, 4.0,
        "gradient-bucket size cap (MB) of the data-parallel all-reduce "
        "(parallel/distributed.py make_grad_sync, "
        "CompiledProgram.with_grad_overlap): gradients are grouped "
        "reverse-topologically into buckets of at most this many bytes, and in "
        "the bucketed mode each bucket's all-reduce starts as soon as backward "
        "has produced its last gradient")
_define("FLAGS_serving_max_queue", int, 256,
        "admission bound on the serving runtime's request queue "
        "(serving/server.py): a submit past this depth is shed with "
        "ServingError(reason='overload'), counted in serving.shed; "
        "Server(max_queue=...) overrides it")
_define("FLAGS_serving_default_deadline_ms", float, 0.0,
        "deadline of a serving submit that passes none: a request still queued "
        "when it expires ends with ServingError(reason='timeout') and its batch "
        "goes on without it.  0 (default): no deadline")
_define("FLAGS_serving_hbm_budget_mb", float, 0.0,
        "device-memory budget of the serving model registry (serving/"
        "registry.py): a load past it evicts the least recently used models, "
        "then refuses with ServingError(reason='hbm_budget').  0 (default): "
        "unlimited")
_define("FLAGS_serving_quant_atol", float, 5e-2,
        "accuracy-parity gate of publishing a quantized model over its float "
        "parent (serving/publisher.py): the staged snapshot's outputs on the "
        "golden smoke's feeds are compared elementwise with the active "
        "version's; a max |diff| past it rejects and quarantines the snapshot "
        "as a NaN weight does, and the parent serves on bit for bit.  Applies "
        "only when the staged dir has a __quant__.json and an active version "
        "of the same feeds and fetches exists")
_define("FLAGS_serving_slo_target", float, 0.99,
        "good-fraction target of the serving SLO gauges (serving/server.py): "
        "burn_rate = bad_frac / (1 - target); sheds, timeouts, errors and late "
        "completions are bad, admission-door rejections are not SLO traffic")
_define("FLAGS_serving_buckets", str, "1,2,4,8,16,32",
        "comma-separated batch buckets the serving runtime warms (serving/"
        "batcher.py): a batch pads up to the next bucket, so a novel size "
        "builds no plan and, on the card, captures no CUDA graph")
_define("FLAGS_lock_telemetry", bool, False,
        "per-lock contention counters for every named lock (core/locks.py): "
        "lock.<name>.acquires/contended/wait_us/hold_us and "
        "lock.order_inversions.  Off (default): one branch over the raw lock")
_define("FLAGS_lock_timeout_s", float, 0.0,
        "deadline on every blocking named-lock acquisition (core/locks.py): "
        "past it the acquire raises errors.LockTimeoutError naming the wanted "
        "lock and every lock the thread holds.  0 (default): no deadline")
_define("FLAGS_ps_timeout_s", float, 10.0,
        "socket deadline on every parameter-server RPC "
        "(param_server.py): connect/send/recv past it "
        "raise a classified TRANSIENT errors.ParamServerError the "
        "KVClient retries with reconnect + backoff instead of "
        "wedging training on a dead pserver forever.  0 = no "
        "deadline (the pre-hardening behavior)")
_define("FLAGS_ps_retries", int, 5,
        "KVClient retry budget per RPC (param_server.py): "
        "transient ParamServerErrors (timeout, connection refused/"
        "reset while the supervisor restarts the pserver) retry with "
        "seeded exponential backoff up to this many attempts; pushes "
        "carry per-client sequence numbers so a retried push applies "
        "EXACTLY once server-side.  Exhausting the budget raises the "
        "last error terminal")
_define("FLAGS_ps_max_frame_mb", int, 256,
        "frame-size cap on the pserver wire protocol "
        "(param_server.py): a length prefix past the cap "
        "is a corrupt/hostile frame and raises a terminal classified "
        "ParamServerError instead of mallocing unbounded on either "
        "end of the socket")
_define("FLAGS_ps_snapshot_every_ops", int, 256,
        "pserver durability cadence (param_server.py): a "
        "full table snapshot commits through the io.py atomic choke "
        "point every N journaled mutating ops; between snapshots the "
        "write-ahead op journal alone replays a crash-restarted "
        "pserver back to bit-identical tables.  0 = journal-only "
        "(snapshot only at stop())")
_define("FLAGS_max_host_lag_steps", int, 0,
        "degraded-mode bound for the host sparse tier "
        "(parallel/embedding.py): the maximum number of "
        "consecutive steps training may run hot-shard-only (zero "
        "cold-tail rows, stale host tables) while the pserver is "
        "down.  Past the bound the next lookup raises a TERMINAL "
        "classified errors.ParamServerError — online learning cannot "
        "silently diverge from its cold tail forever.  0 (default) = "
        "unbounded degraded mode (the sparse.host_lag_steps gauge "
        "and host_tier_degraded events still go loud; gate them with "
        "perf_report --check --max-host-lag-steps)")
# Accepted for scripts written against the reference framework; none of the
# four changes anything in the port.
_define("FLAGS_cudnn_deterministic", bool, True,
        "accepted no-op: it sets nothing on the card.  cuDNN's deterministic "
        "algorithms are torch.backends.cudnn.deterministic, which the caller "
        "sets (the executor's plan key includes it)")
_define("FLAGS_fraction_of_gpu_memory_to_use", float, 1.0,
        "accepted no-op: it reserves nothing on the card.  Device memory is "
        "PyTorch's caching allocator's (torch.cuda.set_per_process_memory_"
        "fraction caps it; the serving registry's budget is "
        "FLAGS_serving_hbm_budget_mb)")
_define("FLAGS_allocator_strategy", str, "auto_growth",
        "accepted no-op: it selects no allocator on the card.  Allocation is "
        "PyTorch's caching allocator's (PYTORCH_CUDA_ALLOC_CONF configures it)")
_define("FLAGS_paddle_num_threads", int, 1,
        "accepted no-op: it sets no thread count.  CPU threading is "
        "torch.set_num_threads / OMP_NUM_THREADS, which the caller sets")
