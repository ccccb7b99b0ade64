"""Windowed latency summaries.

The port's own copy of the two helpers of
``ray_tpu/_private/metrics_history.py`` that the serve router uses to
ship its latency window to the controller; the reference's history plane
around them is not part of it.
"""

from __future__ import annotations

from ray_tpu_torch._private import perf_plane


def snapshot_delta(cur: dict, prev: dict | None) -> dict:
    """The window between two cumulative histogram snapshots: bucket-wise
    difference, clamped at zero (a reset counter cannot give a negative
    bucket). ``prev=None`` gives ``cur`` itself."""
    counts = [int(c) for c in (cur.get("counts") or [])]
    if not prev:
        return {"counts": counts, "sum": float(cur.get("sum", 0.0)),
                "count": int(cur.get("count", 0))}
    prev_counts = list(prev.get("counts") or [])
    n = max(len(counts), len(prev_counts))
    delta_counts = [
        max(0, (int(counts[i]) if i < len(counts) else 0)
            - (int(prev_counts[i]) if i < len(prev_counts) else 0))
        for i in range(n)]
    count = max(0, int(cur.get("count", 0)) - int(prev.get("count", 0)))
    delta_sum = float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0))
    if count == 0 or delta_sum < 0.0:
        delta_sum = 0.0
    return {"counts": delta_counts, "sum": delta_sum, "count": count}


def summarize(snap: dict) -> dict:
    """count / mean / p50 / p99 of one snapshot: what the latency
    autoscaler reads."""
    count = int(snap.get("count", 0))
    return {
        "count": count,
        "mean_s": (float(snap.get("sum", 0.0)) / count) if count else 0.0,
        "p50_s": perf_plane.quantile(snap, 0.5),
        "p99_s": perf_plane.quantile(snap, 0.99),
    }
