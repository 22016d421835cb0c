"""paddle_tpu_torch.serving: the serving runtime (counterpart of
paddle_tpu/serving): the in-process `Server`, and the fleet, `ServingFleet`
(replica processes, each a `Server`, supervised and rolled) behind a
`Router`.

Continuous batching into padded buckets that are warmed into CUDA graphs
at load, per-request deadlines, admission control with load shedding,
several models under a device-memory budget, and verified hot reload with
instant rollback, over the port's `Predictor` and one shared `Executor`.

    from paddle_tpu_torch import serving

    registry = serving.ModelRegistry(hbm_budget_mb=20_000)  # CUDAPlace(0)
    with serving.Server(registry, buckets=(1, 4, 8, 16)) as srv:
        srv.load_model("ranker", "/models/ranker")   # graphs every bucket
        out = srv.infer("ranker", {"x": batch})      # pads, replays a graph
        srv.publish("ranker", ckpt_manager)          # verify -> swap
        srv.rollback("ranker")                       # instant undo

    fleet = serving.ServingFleet({"ranker": "/models/ranker"}, n_replicas=2)
    fleet.wait_healthy()
    out = fleet.infer("ranker", {"x": batch})          # least-inflight pick
    fleet.rolling_publish("ranker", "/models/ranker_v2")  # zero downtime
    fleet.stop()                                       # drain

On the CPU: `serving.ModelRegistry(place=fluid.CPUPlace())` (the plans run
eagerly through the kernels' plain versions), `ServingFleet(...,
place=fluid.CPUPlace())`.  Failures are
`errors.ServingError` with a reason code (overload / timeout / oversize /
bad_request / publish_rejected / publish_io / hbm_budget / model_missing /
shutdown / replica_down); metrics ride the monitor (serving.* counters and
gauges, `serving_batch` / `serving_event` / `serving_trace` records), which
`tools/serve_trace.py --check` and `tools/perf_report.py --check
--max-shed-frac --max-p99-ms` read as they read the JAX package's.
"""
from __future__ import annotations

from .batcher import (DEFAULT_BUCKETS, bucket_for, build_batch,  # noqa: F401
                      coalesce, concat_feeds, pad_feeds, parse_buckets,
                      split_rows, validate_feeds)
from .publisher import (QUARANTINE_MARKER, publish,  # noqa: F401
                        quarantine_marker, rollback, verify_snapshot_dir)
from .registry import (ModelRegistry, ModelVersion,  # noqa: F401
                       manifest_weight_bytes, model_precision,
                       plan_model_bytes, quant_manifest, synthetic_feeds)
from .server import Future, Server  # noqa: F401
from .router import Router  # noqa: F401
from .fleet import ServingFleet  # noqa: F401
from .tracing import (NULL_TRACE, RequestTrace, TRACE_PHASES,  # noqa: F401
                      control_trace_id, maybe_trace)

__all__ = [
    "DEFAULT_BUCKETS", "parse_buckets", "bucket_for", "pad_feeds",
    "concat_feeds", "split_rows", "coalesce", "validate_feeds",
    "build_batch",
    "ModelRegistry", "ModelVersion", "synthetic_feeds",
    "manifest_weight_bytes", "plan_model_bytes",
    "quant_manifest", "model_precision",
    "publish", "rollback", "verify_snapshot_dir",
    "QUARANTINE_MARKER", "quarantine_marker",
    "Server", "Future", "Router", "ServingFleet",
    "RequestTrace", "NULL_TRACE", "maybe_trace", "control_trace_id",
    "TRACE_PHASES",
]
