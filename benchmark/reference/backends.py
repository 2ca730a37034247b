"""Per-backend attribution as the health step consumes it, rebuilt from
the finished claims the benchmark saw: the reference's own table.

Rows are keyed as a deployment's backend registry keys them: row 0 is
the unattributed bucket (key ``''``), and each new key takes the next
row in the order it is first seen, up to ``REGISTRY_ROWS`` rows in all;
a key seen after the registry is full is attributed to row 0. A row
is ``reset`` on the tick in which it first carries traffic.
"""

from __future__ import annotations

import numpy as np
import torch

from .steps import BUCKET_SCALE, LAT_BINS, latency_bucket

#: Rows of the registry, the unattributed one included (12 flag bits
#: less one).
REGISTRY_ROWS = 0xFFF


def _buckets(ms: np.ndarray) -> np.ndarray:
    """``latency_bucket`` of each of ``ms`` (all positive)."""
    return np.minimum((np.log2(1.0 + ms) * BUCKET_SCALE).astype(np.int64),
                      LAT_BINS - 1)


class BackendColumns:
    """Accumulates one tick of observations and hands them over as the
    health step's [rows] input columns."""

    def __init__(self, rows: int = REGISTRY_ROWS + 1):
        self.rows = rows
        self.keys = ['']
        self.index = {'': 0}
        self.seen = np.zeros(rows, bool)
        self._zero()

    def _zero(self):
        n = self.rows
        self.lat_sum = np.zeros(n, np.float64)
        self.lat_count = np.zeros(n, np.int64)
        self.lat_buckets = np.zeros((n, LAT_BINS), np.int64)
        self.claim_buckets = np.zeros((n, LAT_BINS), np.int64)
        self.errors = np.zeros(n, np.int64)
        self.shed = np.zeros(n, np.int64)
        self.fresh = set()

    def row(self, key) -> int:
        key = str(key or '')
        idx = self.index.get(key)
        if idx is None:
            if len(self.keys) >= REGISTRY_ROWS:
                idx = 0
            else:
                idx = len(self.keys)
                self.keys.append(key)
                self.index[key] = idx
        if not self.seen[idx]:
            self.seen[idx] = True
            self.fresh.add(idx)
        return idx

    def observe(self, key, service_ms, claim_ms, ok: bool) -> None:
        r = self.row(key)
        if ok and service_ms is not None:
            self.lat_sum[r] += float(service_ms)
            self.lat_count[r] += 1
            self.lat_buckets[r, latency_bucket(float(service_ms))] += 1
        elif not ok:
            self.errors[r] += 1
        if claim_ms is not None:
            self.claim_buckets[r, latency_bucket(float(claim_ms))] += 1

    def observe_many(self, keys: list, index, ms, ok) -> None:
        """Finished claims in bulk: claim ``j`` went to backend
        ``keys[index[j]]``, took ``ms[j] + 1`` ms in all and ``ms[j]`` in
        service when ``ok[j]`` (failed otherwise)."""
        index = np.asarray(index)
        _, first = np.unique(index, return_index=True)
        rows_of = {}
        for j in np.sort(first):
            rows_of[int(index[j])] = self.row(keys[int(index[j])])
        rows = np.array([rows_of[int(i)] for i in index], np.int64)
        ms = np.asarray(ms, np.float64)
        ok = np.asarray(ok, bool)
        np.add.at(self.lat_sum, rows[ok], ms[ok])
        np.add.at(self.lat_count, rows[ok], 1)
        np.add.at(self.lat_buckets, (rows[ok], _buckets(ms[ok])), 1)
        np.add.at(self.errors, rows[~ok], 1)
        np.add.at(self.claim_buckets, (rows, _buckets(ms + 1.0)), 1)

    def observe_shed(self, key) -> None:
        self.shed[self.row(key)] += 1

    def drain(self, device) -> dict:
        """One tick's input columns as tensors on ``device``; the
        accumulators start again from zero."""
        reset = np.zeros(self.rows, bool)
        reset[list(self.fresh)] = True
        eligible = self.seen.copy()
        eligible[0] = False

        def t(a, dtype):
            return torch.as_tensor(a, dtype=dtype, device=device)
        out = {
            'lat_sum': t(self.lat_sum.astype(np.float32), torch.float32),
            'lat_count': t(self.lat_count, torch.int32),
            'lat_buckets': t(self.lat_buckets, torch.int32),
            'claim_buckets': t(self.claim_buckets, torch.int32),
            'errors': t(self.errors, torch.int32),
            'shed': t(self.shed, torch.int32),
            'active': t(self.seen, torch.bool),
            'eligible': t(eligible, torch.bool),
            'reset': t(reset, torch.bool),
        }
        self._zero()
        return out

    def key_for(self, row: int):
        return self.keys[row] if row < len(self.keys) else None
