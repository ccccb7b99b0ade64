"""Deterministic fault injection: seeded, named sites.

The port of ``ray_tpu/_private/chaos.py``. ``chaos.ACTIVE`` is a module
global that stays ``None`` unless ``RAY_TPU_TORCH_CHAOS`` is set or
``configure()`` is called, so a site costs one branch::

    if chaos.ACTIVE is not None and chaos.ACTIVE.should("gcs.torn_wal"):

Spec grammar::

    seed=42,gcs.torn_wal=0.5,gcs.torn_snapshot=1.0x1

``site=rate`` fires with probability ``rate`` per hit from one seeded
RNG (the same seed and call order give the same fires, draw for draw
as the reference's controller); ``site=ratexN`` caps the site at N
fires (``1.0x1``: exactly the first hit).

Sites wired in the port (``SITES``):

- ``gcs.torn_snapshot`` head persistence: truncate a snapshot's payload
  under a full-length header; restore detects the tear by CRC and falls
  back to the previous snapshot and the WAL
- ``gcs.torn_wal`` head persistence: write a WAL record's payload short
  under a full-length header (the SIGKILL-mid-append shape); restart
  truncates the torn tail and replays everything before it
- ``gcs.shard_die`` sharded head (``gcs_shards`` > 1): crash-restart the
  shard owning the mutation in flight; it replays only its own WAL and
  mints its next epoch, so the in-flight write (stamped with the epoch
  before the death) is refused typed, and the other shards serve on
- ``gcs.shard_stall`` sharded head: wedge the owning shard for
  ``RAY_TPU_TORCH_SHARD_STALL_S`` (default 2.0) x U[0.5, 1.5) seconds;
  reads serve its stale view, writes queue WAL-first and shed past
  ``gcs_shard_max_queued_writes``
- ``sched.straggle`` daemon exec: delay this node's single-path
  execution by ``RAY_TPU_TORCH_STRAGGLE_S`` seconds (default 2.0) before
  the user function runs, in short slices, so a speculation loser's
  cancel that lands mid-delay stops it before it runs; a batch RPC is
  delayed once, before its entries are admitted

Every fire is recorded in the process's flight-recorder ring
(``chaos``, site).

Not ported (ROADMAP item 10c): every other site of the reference (the
transport's sever, drop, delay and stream kill, network partitions,
heartbeat skips, daemon death, lease expiry, overload, the
spill tier's torn write, disk full and restore delay, the LLM engine's
slow step) and the trace pins a fire leaves.
"""

from __future__ import annotations

import os
import random
import threading

SITES: "tuple[str, ...]" = (
    "gcs.torn_snapshot",
    "gcs.torn_wal",
    "gcs.shard_die",
    "gcs.shard_stall",
    "sched.straggle",
)

CHAOS_ENV = "RAY_TPU_TORCH_CHAOS"


class ChaosController:
    """Seeded, named injection points with per-site rates and caps."""

    def __init__(self, rates: "dict[str, tuple[float, int | None]]",
                 seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self._rates = dict(rates)
        self._lock = threading.Lock()
        self.injected: dict[str, int] = {}

    def should(self, site: str) -> bool:
        """One seeded draw for ``site``; True means the caller injects
        the fault (and the fire was counted)."""
        entry = self._rates.get(site)
        if entry is None:
            return False
        rate, cap = entry
        if rate <= 0.0:
            return False
        with self._lock:
            if cap is not None and self.injected.get(site, 0) >= cap:
                return False
            fire = self._rng.random() < rate
            if fire:
                self.injected[site] = self.injected.get(site, 0) + 1
        if fire:
            from ray_tpu_torch._private import flight_recorder

            flight_recorder.record("chaos", site)
        return fire

    def uniform(self) -> float:
        """A seeded draw in [0, 1) for a site that needs a magnitude
        (a stall's length) beside its fire decision."""
        with self._lock:
            return self._rng.random()


def _parse(spec: str) -> "tuple[dict, int]":
    rates: dict[str, tuple[float, int | None]] = {}
    seed = 0
    for item in spec.replace(";", ",").split(","):
        item = item.strip()
        if not item or "=" not in item:
            continue
        key, _, value = item.partition("=")
        key = key.strip()
        value = value.strip()
        if key == "seed":
            seed = int(value)
            continue
        cap: int | None = None
        if "x" in value:
            value, _, cap_s = value.partition("x")
            cap = int(cap_s)
        rates[key] = (float(value), cap)
    return rates, seed


# None unless chaos is configured.
ACTIVE: ChaosController | None = None


def configure(spec: "str | None") -> ChaosController | None:
    """Install (or clear, with a falsy spec) the process-wide
    controller."""
    global ACTIVE
    if not spec:
        ACTIVE = None
        return None
    rates, seed = _parse(spec)
    ACTIVE = ChaosController(rates, seed)
    return ACTIVE


def disable() -> None:
    configure(None)


def should(site: str) -> bool:
    controller = ACTIVE
    return controller is not None and controller.should(site)


# A spawned head picks chaos up from its environment.
_env_spec = os.environ.get(CHAOS_ENV, "")
if _env_spec:
    configure(_env_spec)
