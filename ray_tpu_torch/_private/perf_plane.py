"""Fixed-bucket latency histograms.

The port's own copy of what the serve router reads from
``ray_tpu/_private/perf_plane.py``: the log2 buckets, ``StageHistogram``
and ``quantile``. The reference's per-task resource attribution and its
process-wide stage registry are not part of it.
"""

from __future__ import annotations

import threading

# Bucket i covers (2^(i-1) us, 2^i us]; the last bucket is +Inf.
N_BUCKETS = 26
BUCKET_BOUNDS = tuple(1e-6 * (1 << i) for i in range(N_BUCKETS))


def _bucket_index(dt_s: float) -> int:
    """The log2 bucket of a duration: bucket i holds durations in
    (2^(i-1), 2^i] microseconds (sub-us lands in bucket 0; overflow in
    the +Inf bucket)."""
    if dt_s <= 0.0:
        return 0
    n = int(dt_s * 1e6)
    if n <= 1:
        return 0
    idx = (n - 1).bit_length()
    return idx if idx < N_BUCKETS else N_BUCKETS


class StageHistogram:
    """A latency histogram: ``observe`` takes one short lock;
    ``snapshot()`` gives ``{"counts": [N_BUCKETS + 1 ints], "sum": s,
    "count": n}``."""

    __slots__ = ("_counts", "_sum", "_count", "_lock")

    def __init__(self):
        self._counts = [0] * (N_BUCKETS + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, dt_s: float) -> None:
        idx = _bucket_index(dt_s)
        with self._lock:
            self._counts[idx] += 1
            self._sum += dt_s
            self._count += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self._counts), "sum": self._sum,
                    "count": self._count}


def quantile(snap: dict, q: float) -> float:
    """A quantile of a snapshot, interpolated linearly inside its bucket
    (bounded by the bucket's edge); the +Inf bucket reports the largest
    finite bound."""
    counts = snap.get("counts") or []
    total = int(snap.get("count", 0))
    if total <= 0 or not counts:
        return 0.0
    target = q * total
    seen = 0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if seen + c >= target:
            hi = BUCKET_BOUNDS[i] if i < N_BUCKETS else BUCKET_BOUNDS[-1]
            lo = BUCKET_BOUNDS[i - 1] if 0 < i <= N_BUCKETS else 0.0
            frac = (target - seen) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += c
    return BUCKET_BOUNDS[-1]
