"""Metrics (counterpart of paddle_tpu/metrics.py): MetricBase, Accuracy,
Precision, Recall, Auc, EditDistance, CompositeMetric.  Host-side
accumulators over fetched numpy values, numpy only: the same inputs give
the same values in both packages."""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class MetricBase:
    def __init__(self, name: Optional[str] = None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue
            if isinstance(v, (int, float)):
                setattr(self, k, 0 if isinstance(v, int) else 0.0)
            elif isinstance(v, list):
                setattr(self, k, [])

    def update(self, *a, **k):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        value = float(np.asarray(value).reshape(-1)[0])
        weight = float(np.asarray(weight).reshape(-1)[0])
        if weight < 0:
            raise ValueError("weight must be non-negative")
        self.value += value * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy: no samples accumulated")
        return self.value / self.weight


class Precision(MetricBase):
    """Binary precision."""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fp = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").reshape(-1)
        labels = np.asarray(labels).astype("int32").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def eval(self):
        ap = self.tp + self.fp
        return self.tp / ap if ap else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0.0
        self.fn = 0.0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").reshape(-1)
        labels = np.asarray(labels).astype("int32").reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def eval(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(MetricBase):
    """Threshold-bucketed ROC AUC."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(num_thresholds + 1, dtype=np.int64)

    def reset(self):
        self._stat_pos[:] = 0
        self._stat_neg[:] = 0

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 and preds.shape[1] > 1 else preds.reshape(-1)
        buckets = np.clip((pos_prob * self._num_thresholds).astype(np.int64), 0, self._num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        for i in range(self._num_thresholds, -1, -1):
            p, n = self._stat_pos[i], self._stat_neg[i]
            auc += n * (tot_pos + p / 2.0)
            tot_pos += p
            tot_neg += n
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        d = np.asarray(distances, dtype=np.float64).reshape(-1)
        self.total_distance += float(d.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((d > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance: no data")
        return self.total_distance / self.seq_num, self.instance_error / self.seq_num


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics: List[MetricBase] = []

    def add_metric(self, metric: MetricBase):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


def edit_distance_np(a: str, b: str) -> int:
    """The Levenshtein distance of two strings."""
    la, lb = len(a), len(b)
    dp = np.arange(lb + 1)
    for i in range(1, la + 1):
        prev = dp.copy()
        dp[0] = i
        for j in range(1, lb + 1):
            dp[j] = min(prev[j] + 1, dp[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
    return int(dp[lb])
