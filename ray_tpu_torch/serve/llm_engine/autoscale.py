"""Latency-driven replica autoscaling policy.

A copy of ``ray_tpu/serve/llm_engine/autoscale.py``: a pure object over a
config with ``min_replicas``, ``max_replicas``, ``target_p99_s``,
``target_ongoing_requests``, ``metrics_interval_s``, ``upscale_delay_s``
and ``downscale_delay_s`` (the reference's ``AutoscalingConfig``).

Closes the observability loop for the serve tier: the controller's
autoscale pass feeds this policy the LIVE ``Router.latency_stats()``
p50/p99 (pushed by every router at ``serve_latency_report_s`` cadence)
plus the engine/replica queue depth, and gets back a target replica
count within ``[min_replicas, max_replicas]``.

Shape of the policy (kept a pure object so the unit tests drive it
with a fake stats feed and an injected clock):

- **scale up** when p99 exceeds ``target_p99_s``: multiplicative —
  the violated ratio (capped at 2x per decision) times the current
  count, so a 4x p99 blowout recovers in two decisions instead of
  creeping one replica per window;
- **scale down** when p99 sits under half the target AND per-replica
  depth is under ``target_ongoing_requests`` — one replica at a time
  (downscaling sheds warm caches; be gentle);
- **cooldowns** damp flapping: ``upscale_delay_s`` /
  ``downscale_delay_s`` gate same-direction moves, and a DIRECTION
  FLIP additionally waits out the opposite cooldown from the last
  change — a p99 spike right after a downscale re-expands after
  ``upscale_delay_s``, but oscillation can never beat
  ``downscale_delay_s`` per cycle;
- **stale feeds freeze** the policy: a report older than
  ``3 x metrics_interval_s + 1s`` returns the current count (no
  latency signal beats a wrong one).
"""

from __future__ import annotations

import math


class LatencyPolicy:
    """One per autoscaled deployment (controller-side)."""

    def __init__(self, cfg):
        # cfg: an autoscaling config with target_p99_s > 0.
        self.cfg = cfg
        self._last_change_ts = 0.0
        self._last_dir = 0  # -1 down / 0 none / +1 up

    def desired(self, current: int, p99_s: float, depth: float,
                now: float, feed_age_s: float = 0.0) -> int:
        """Target replica count for this decision window."""
        cfg = self.cfg
        lo, hi = cfg.min_replicas, cfg.max_replicas
        current = max(1, current)
        if feed_age_s > 3.0 * cfg.metrics_interval_s + 1.0:
            return max(lo, min(hi, current))
        target = float(cfg.target_p99_s)
        desired = current
        direction = 0
        if target > 0 and p99_s > target:
            ratio = min(2.0, p99_s / target)
            desired = min(hi, math.ceil(current * ratio))
            # Depth floor: even a modest p99 violation scales far
            # enough to drain the standing queue.
            if cfg.target_ongoing_requests > 0:
                desired = max(desired, min(hi, math.ceil(
                    depth / cfg.target_ongoing_requests)))
            direction = +1 if desired > current else 0
        elif (target > 0 and p99_s < 0.5 * target
              and depth / current < cfg.target_ongoing_requests
              and current > lo):
            desired = current - 1
            direction = -1
        if direction == 0 or desired == current:
            return max(lo, min(hi, current))
        # Cooldowns: same-direction delay, plus the OPPOSITE delay on
        # a direction flip (flap damping).
        delay = (cfg.upscale_delay_s if direction > 0
                 else cfg.downscale_delay_s)
        if self._last_dir != 0 and direction != self._last_dir:
            delay = max(delay, cfg.downscale_delay_s
                        if self._last_dir < 0 else cfg.upscale_delay_s)
        if now - self._last_change_ts < delay:
            return max(lo, min(hi, current))
        self._last_change_ts = now
        self._last_dir = direction
        return max(lo, min(hi, desired))

    def note_external_change(self, now: float) -> None:
        """The controller scaled for another reason (redeploy, health
        demotion): restart the cooldown clock so the policy does not
        immediately fight the change."""
        self._last_change_ts = now
        self._last_dir = 0
