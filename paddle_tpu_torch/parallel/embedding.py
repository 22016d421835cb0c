"""Embedding parallelism (counterpart of paddle_tpu/parallel/embedding.py):
for now `TieredEmbedding`, the host tier of a table; `sharded_lookup`, the
mesh-sharded lookup, comes with data parallelism (ROADMAP A10).

`TieredEmbedding` keeps the HOT head of the vocabulary (the rows every
batch touches) in this process, trained in place, and the COLD tail -- the
part that does not fit -- on the supervised parameter server behind
`HostTableEmbedding`.  Both tiers are numpy on the host: the device program
sees the looked-up rows as a feed and hands their gradient back.  The tier
inherits the host tier's fault story: a down pserver degrades the cold tail
(zero rows, dropped pushes, `sparse.host_lag_steps` bounded by
FLAGS_max_host_lag_steps) while hot-row training goes on untouched.
"""
from __future__ import annotations

import numpy as np

__all__ = ["TieredEmbedding"]


class TieredEmbedding:
    """Hot head in this process + host-tiered cold tail for one logical
    (V, D) table.

    Rows [0, hot_rows) are the hot shard: held locally (feedable to the
    device program), updated in place with SGD.  Rows [hot_rows,
    vocab_size) are the cold tail on the parameter server via
    `HostTableEmbedding` -- pulled per batch, row gradients pushed back with
    the client's exactly-once sequenced pushes.

    While the pserver tier is down (its supervisor mid-restart or out of
    budget) and `degraded_ok=True`, steps keep running HOT-SHARD-ONLY: cold
    lookups return zeros, cold pushes are dropped (counted), and
    `host_lag_steps` / the `sparse.host_lag_steps` gauge track the outage --
    terminal past FLAGS_max_host_lag_steps.  A dead host tier costs
    cold-tail freshness, never the run."""

    def __init__(self, client, name: str, vocab_size: int, dim: int,
                 hot_rows: int, lr: float = 0.1, degraded_ok: bool = True,
                 seed: int = 0, scale: float = 0.01, create: bool = True):
        from ..param_server import HostTableEmbedding

        if not 0 < hot_rows <= vocab_size:
            raise ValueError(f"hot_rows={hot_rows} must be in "
                             f"(0, vocab_size={vocab_size}]")
        self.name = name
        self.vocab_size, self.dim, self.hot_rows = vocab_size, dim, hot_rows
        self.lr = lr
        rng = np.random.RandomState(seed)
        self.hot = (rng.randn(hot_rows, dim) * scale).astype(np.float32)
        self.host = HostTableEmbedding(client, name, dim,
                                       degraded_ok=degraded_ok)
        if create and vocab_size > hot_rows:
            client.create(name, (rng.randn(vocab_size - hot_rows, dim)
                                 * scale).astype(np.float32))

    @property
    def host_lag_steps(self) -> int:
        return self.host.host_lag_steps

    def lookup(self, ids: np.ndarray) -> np.ndarray:
        """ids (...,) int -> (..., D) float32 rows across both tiers."""
        ids = np.asarray(ids, np.int64)
        flat = ids.reshape(-1)
        out = np.zeros((flat.size, self.dim), np.float32)
        hot_mask = flat < self.hot_rows
        if hot_mask.any():
            out[hot_mask] = self.hot[flat[hot_mask]]
        cold = flat[~hot_mask] - self.hot_rows
        if cold.size:
            uniq, local, rows = self.host.prepare_batch(cold)
            out[~hot_mask] = rows[local]
        return out.reshape(ids.shape + (self.dim,))

    def apply_grad(self, ids: np.ndarray, grad_rows: np.ndarray):
        """SGD on the hot shard in place; a sequenced push for the cold
        tail (dropped, counted, while the tier is degraded)."""
        flat = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grad_rows, np.float32).reshape(-1, self.dim)
        hot_mask = flat < self.hot_rows
        if hot_mask.any():
            np.add.at(self.hot, flat[hot_mask], -self.lr * grads[hot_mask])
        cold = flat[~hot_mask] - self.hot_rows
        if cold.size:
            uniq, inv = np.unique(cold, return_inverse=True)
            merged = np.zeros((uniq.size, self.dim), np.float32)
            np.add.at(merged, inv, grads[~hot_mask])
            self.host.push_grad(uniq, merged)

    def export_selected_rows(self):
        """The FULL logical table as one SelectedRows (the hot head from
        here, the cold tail fetched from the pserver): the payload an
        online run snapshots and publishes into serving.  Raises the
        client's classified ParamServerError when the tier is down past its
        retry budget: a publish never ships a zeros-for-cold-tail
        snapshot.  Rows and values are CPU tensors (int64 ids, as the JAX
        package's snapshot files hold them)."""
        import torch

        from ..core.selected_rows import SelectedRows

        parts = [self.hot]
        if self.vocab_size > self.hot_rows:
            parts.append(np.asarray(self.host.client.fetch_table(self.name),
                                    np.float32))
        values = np.concatenate(parts, axis=0)
        return SelectedRows(torch.arange(self.vocab_size, dtype=torch.int64),
                            torch.from_numpy(values), height=self.vocab_size)
