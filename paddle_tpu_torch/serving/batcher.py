"""Bucket policy and continuous-batch assembly of the serving runtime
(counterpart of paddle_tpu/serving/batcher.py; numpy on the host).

On the card every new feed shape is a new executor plan: its first run is
eager and its second captures a CUDA graph (core/executor.py), which takes
hundreds of milliseconds for BERT-base.  So the server serves a fixed
ladder of batch buckets (FLAGS_serving_buckets, default 1,2,4,8,16,32) a
model, warms each into a graph at load (or in the publisher's pre-swap
lane), and pads every batch up to the next bucket: steady-state serving
builds no plan and captures no graph.

Padding repeats the batch's first row rather than writing zeros: the pad
rows are sliced off before any client sees them, but zero rows can drive a
model through poles real data never visits (log(0), a zero norm), and a
NaN in a pad row would still trip FLAGS_check_nan_inf for the batch.

Everything here is pure (no queue, no threads): `Server` owns the queue.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..errors import ServingError
from ..flags import flag as _flag

__all__ = ["DEFAULT_BUCKETS", "parse_buckets", "bucket_for", "batch_rows",
           "validate_feeds", "pad_feeds", "concat_feeds", "split_rows",
           "coalesce", "build_batch"]

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


def parse_buckets(spec=None) -> Tuple[int, ...]:
    """Sorted, deduplicated bucket ladder from a sequence or a
    comma-separated string (None -> FLAGS_serving_buckets)."""
    if spec is None:
        spec = _flag("FLAGS_serving_buckets") or ""
    if isinstance(spec, str):
        parts = [p.strip() for p in spec.split(",") if p.strip()]
        sizes = [int(p) for p in parts]
    else:
        sizes = [int(s) for s in spec]
    sizes = sorted(set(sizes))
    if not sizes or sizes[0] < 1:
        raise ValueError(f"serving buckets must be positive ints, got {spec!r}")
    return tuple(sizes)


def bucket_for(rows: int, buckets: Sequence[int]) -> int:
    """Smallest bucket that fits `rows`; classified refusal past the top
    (an oversize request must be split by the CLIENT — silently chunking
    it would reorder its rows relative to admission)."""
    for b in buckets:
        if rows <= b:
            return b
    raise ServingError(
        f"request carries {rows} rows but the largest compiled bucket is "
        f"{buckets[-1]}; split the request or widen FLAGS_serving_buckets",
        reason="oversize")


def batch_rows(feeds: Dict[str, np.ndarray]) -> int:
    """The (validated) leading batch dim shared by every feed."""
    rows = None
    for name, v in feeds.items():
        shape = np.shape(v)
        if len(shape) == 0:
            raise ServingError(
                f"feed {name!r} is a scalar; serving feeds carry a leading "
                f"batch dim", reason="bad_request")
        if rows is None:
            rows = int(shape[0])
        elif int(shape[0]) != rows:
            raise ServingError(
                f"feed {name!r} has batch dim {shape[0]} but the request's "
                f"other feeds have {rows}", reason="bad_request")
    if not rows:
        raise ServingError("empty request (0 rows)", reason="bad_request")
    return rows


def validate_feeds(feeds: Dict[str, np.ndarray], feed_names: Sequence[str],
                   block) -> None:
    """Admission-time validation against the model's feed contract: the
    exact feed-name set (an extra feed would also change the plan key and
    defeat the bucket warm) and the declared trailing dims (the batch dim
    is free).  A malformed request fails alone at the door; coalesced
    into a batch, its shape error would fail every request beside it."""
    missing = sorted(set(feed_names) - set(feeds))
    extra = sorted(set(feeds) - set(feed_names))
    if missing or extra:
        raise ServingError(
            f"request feeds do not match the model's contract "
            f"(missing {missing}, unexpected {extra})",
            reason="bad_request")
    for n in feed_names:
        shape = tuple(np.shape(feeds[n]))
        declared = list(block.var(n).shape or []) if block.has_var(n) else []
        if not declared:
            continue
        if (len(shape) != len(declared)
                or any(d >= 0 and s != d
                       for s, d in zip(shape[1:], declared[1:]))):
            raise ServingError(
                f"feed {n!r} shape {shape} does not match the declared "
                f"{declared} (batch dim free)", reason="bad_request")


def concat_feeds(feed_list: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack several requests' feeds along the batch dim (axis 0)."""
    names = feed_list[0].keys()
    return {n: np.concatenate([np.asarray(f[n]) for f in feed_list], axis=0)
            for n in names}


def pad_feeds(feeds: Dict[str, np.ndarray], bucket: int) -> Dict[str, np.ndarray]:
    """Pad every feed's batch dim up to `bucket` by repeating row 0."""
    out = {}
    for n, v in feeds.items():
        arr = np.asarray(v)
        pad = bucket - arr.shape[0]
        if pad < 0:
            raise ServingError(
                f"feed {n!r}: {arr.shape[0]} rows exceed bucket {bucket}",
                reason="oversize")
        if pad:
            filler = np.repeat(arr[:1], pad, axis=0)
            arr = np.concatenate([arr, filler], axis=0)
        out[n] = arr
    return out


def split_rows(outputs: Sequence[np.ndarray], offsets: Sequence[Tuple[int, int]],
               padded_rows: int) -> List[List[np.ndarray]]:
    """Slice a padded batch's outputs back into per-request results.

    `offsets` is [(start, stop), ...] per request in concat order.  An
    output whose leading dim equals the padded batch is per-row and gets
    sliced; anything else (a batch-level scalar metric) is handed to every
    request whole."""
    out = []
    for start, stop in offsets:
        vals = []
        for o in outputs:
            arr = np.asarray(o)
            if arr.ndim >= 1 and arr.shape[0] == padded_rows:
                vals.append(arr[start:stop])
            else:
                vals.append(arr)
        out.append(vals)
    return out


def build_batch(requests, buckets: Sequence[int]):
    """Concat, bucket and pad one coalesced pick: returns `(padded_feeds,
    rows, bucket, pad_rows)`, so the server can attribute pad waste per
    bucket (`serving.pad_rows` counter, `serving.bucket[N].pad_frac`
    gauges) and stamp it into each member request's `batch_build` span."""
    feeds = concat_feeds([r.feeds for r in requests])
    rows = sum(r.rows for r in requests)
    bucket = bucket_for(rows, buckets)
    return pad_feeds(feeds, bucket), rows, bucket, bucket - rows


def coalesce(requests, max_rows: int):
    """Greedy continuous-batching pick: from a FIFO snapshot of queued
    requests, take the head request's model and every later request for
    the SAME model that still fits under `max_rows` total.  Returns
    (model, picked_requests); requests not picked keep their queue order.
    Head-of-line requests of OTHER models are untouched — the caller's
    next loop iteration serves them."""
    head = requests[0]
    picked = [head]
    total = head.rows
    for r in list(requests)[1:]:
        if r.model != head.model:
            continue
        if total + r.rows > max_rows:
            break
        picked.append(r)
        total += r.rows
    return head.model, picked
