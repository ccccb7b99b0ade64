"""Rendezvous actor backing the host-side collective backend.

The port of ``ray_tpu/util/collective/store.py``: every rank contributes
a payload for (op sequence number), and the store releases the full set
once ``world_size`` contributions arrived. Contributions are carried as
they come:

- a numpy array keeps numpy's semantics (``np.result_type`` promotion,
  numpy's arithmetic);
- a ``torch.Tensor`` stays a tensor on its own device: it is promoted
  with ``torch.promote_types`` and reduced where the accumulator lives
  (the first arrival's device), never through ``.numpy()``, which has
  no bfloat16. Each rank's result is its own copy on its own
  contribution's device.

A reduction accumulates in arrival order, as in the reference: a sum
over more than two ranks is the same on every rank, but not fixed by
rank order.
"""

from __future__ import annotations

import threading
import time
from typing import Any

import numpy as np
import torch


def _copy(value: Any, like: Any = None) -> Any:
    """A rank's own copy of ``value``: a tensor on ``like``'s device when
    ``like`` is a tensor (else on its own), a numpy array copied."""
    if isinstance(value, torch.Tensor):
        device = like.device if isinstance(like, torch.Tensor) \
            else value.device
        return value.to(device, copy=True)
    if isinstance(value, np.ndarray):
        return value.copy()
    return value


def _combine(acc: Any, value: Any, reduce_op: str) -> Any:
    """``acc`` op ``value``, promoted to the common dtype whatever the
    order of arrival."""
    if isinstance(acc, torch.Tensor) != isinstance(value, torch.Tensor):
        raise TypeError(
            f"cannot reduce a {type(value).__name__} into a "
            f"{type(acc).__name__}: every rank of an op must contribute "
            f"tensors, or every rank numpy arrays")
    if isinstance(acc, torch.Tensor):
        common = torch.promote_types(acc.dtype, value.dtype)
        acc = acc.to(common)
        value = value.to(acc.device, common)
        ops = {"sum": torch.add, "mean": torch.add, "product": torch.mul,
               "min": torch.minimum, "max": torch.maximum}
    else:
        common = np.result_type(acc.dtype, value.dtype)
        if acc.dtype != common:
            acc = acc.astype(common)
        ops = {"sum": np.add, "mean": np.add, "product": np.multiply,
               "min": np.minimum, "max": np.maximum}
    if reduce_op not in ops:
        raise ValueError(f"unknown reduce op {reduce_op!r}")
    return ops[reduce_op](acc, value)


class CollectiveStore:
    """Runs as a named actor, one per collective group."""

    def __init__(self, world_size: int):
        self._world = world_size
        self._lock = threading.Condition()
        # op_key -> {rank: payload}
        self._pending: dict[str, dict] = {}
        # op_key -> number of ranks that already collected (for cleanup)
        self._collected: dict[str, int] = {}
        # (src, dst, tag) point-to-point mailboxes: FIFO queues, so
        # back-to-back sends before the first recv are not lost.
        self._mailbox: dict[tuple, list] = {}

    def world_size(self) -> int:
        return self._world

    def _wait_for_all(self, op_key: str, arrived, deadline: float,
                      timeout_s: float, slot: dict | None = None) -> None:
        """Block (holding the condition) until ``arrived()`` is the world
        size; on timeout drop the op's slot (the op is broken for the
        whole group) and raise. A contribution that could not be reduced
        (``slot["error"]``) fails every rank of the op."""
        while (count := arrived()) < self._world:
            if slot is not None and slot.get("error") is not None:
                raise slot["error"]
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._pending.pop(op_key, None)
                self._collected.pop(op_key, None)
                raise TimeoutError(
                    f"collective {op_key}: only {count}/{self._world} "
                    f"ranks arrived within {timeout_s}s")
            self._lock.wait(remaining)

    def _release(self, op_key: str) -> None:
        """Count one rank's collection; the last one frees the slot."""
        self._collected[op_key] = self._collected.get(op_key, 0) + 1
        if self._collected[op_key] >= self._world:
            self._pending.pop(op_key, None)
            del self._collected[op_key]

    def exchange(self, op_key: str, rank: int, payload: Any,
                 timeout_s: float = 60.0) -> dict[int, Any]:
        """Contribute and block until every rank contributed; returns
        {rank: payload} for the whole group, each a copy of its own (on
        this rank's device where the payloads are tensors)."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            slot = self._pending.setdefault(op_key, {})
            if rank in slot:
                raise RuntimeError(
                    f"rank {rank} contributed twice to {op_key}: "
                    f"collective calls out of order?")
            slot[rank] = payload
            self._lock.notify_all()
            self._wait_for_all(op_key, lambda: len(slot), deadline,
                               timeout_s)
            result = {r: _copy(p, payload) for r, p in slot.items()}
            self._release(op_key)
            return result

    # -------------------------------------------------- reducing exchanges

    def reduce_exchange(self, op_key: str, rank: int, payload,
                        reduce_op: str, timeout_s: float = 60.0):
        """Allreduce with store-side incremental reduction: each rank
        ships its array or tensor once and receives one reduced copy.
        MEAN is SUM here; the caller divides."""
        deadline = time.monotonic() + timeout_s
        if not isinstance(payload, torch.Tensor):
            payload = np.asarray(payload)
        with self._lock:
            slot = self._pending.setdefault(
                op_key, {"acc": None, "count": 0, "ranks": set()})
            if rank in slot["ranks"]:
                raise RuntimeError(
                    f"rank {rank} contributed twice to {op_key}: "
                    f"collective calls out of order?")
            slot["ranks"].add(rank)
            try:
                slot["acc"] = _copy(payload) if slot["acc"] is None \
                    else _combine(slot["acc"], payload, reduce_op)
            except (TypeError, ValueError) as exc:
                slot["error"] = exc
                self._lock.notify_all()
                raise
            slot["count"] += 1
            self._lock.notify_all()
            self._wait_for_all(op_key, lambda: slot["count"], deadline,
                               timeout_s, slot)
            # A copy per rank: in-process actors share objects by
            # reference, so the live accumulator would alias one buffer
            # across every rank.
            result = _copy(slot["acc"], payload)
            self._release(op_key)
            return result

    def reduce_scatter(self, op_key: str, rank: int, payload,
                       reduce_op: str, timeout_s: float = 60.0):
        """Store-side reduce, then each rank takes only its shard."""
        reduced = self.reduce_exchange(op_key, rank, payload, reduce_op,
                                       timeout_s)
        if isinstance(reduced, torch.Tensor):
            return torch.tensor_split(reduced, self._world, dim=0)[rank] \
                .clone()
        return np.array_split(reduced, self._world, axis=0)[rank]

    def broadcast_value(self, op_key: str, rank: int, payload,
                        src_rank: int, timeout_s: float = 60.0):
        """Only the source ships a payload; receivers block for it and
        each gets its own copy (on the source's device: the caller moves
        a tensor to its own). No full-group barrier, as NCCL's broadcast
        has none between receivers."""
        deadline = time.monotonic() + timeout_s
        with self._lock:
            slot = self._pending.setdefault(
                op_key, {"value": None, "have": False, "taken": 0})
            if rank == src_rank:
                slot["value"] = payload
                slot["have"] = True
                self._lock.notify_all()
            while not slot["have"]:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._pending.pop(op_key, None)
                    raise TimeoutError(
                        f"broadcast {op_key}: src rank {src_rank} "
                        f"never arrived within {timeout_s}s")
                self._lock.wait(remaining)
            value = slot["value"]
            slot["taken"] += 1
            if slot["taken"] >= self._world:
                self._pending.pop(op_key, None)
            if value is None or isinstance(value, torch.Tensor):
                return _copy(value)
            return np.asarray(value).copy()

    # ------------------------------------------------------ point-to-point

    def p2p_put(self, key: tuple, payload: Any) -> None:
        with self._lock:
            self._mailbox.setdefault(key, []).append(_copy(payload))
            self._lock.notify_all()

    def p2p_take(self, key: tuple, timeout_s: float = 60.0) -> Any:
        deadline = time.monotonic() + timeout_s
        with self._lock:
            while not self._mailbox.get(key):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"recv {key}: no matching send "
                                       f"within {timeout_s}s")
                self._lock.wait(remaining)
            queue = self._mailbox[key]
            payload = queue.pop(0)
            if not queue:
                del self._mailbox[key]
            return payload
