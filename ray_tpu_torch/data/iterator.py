"""Batch iteration, including the device feed (the port of
``ray_tpu/data/iterator.py``).

Reference: python/ray/data/iterator.py (iter_batches / iter_torch_batches).
The JAX package's device path is ``iter_jax_batches``: host batches staged
with ``jax.device_put`` one batch ahead. Its counterpart here is
``iter_device_batches``: numpy batches copied through pinned host memory
to the card on a side stream, one batch ahead (``_device_feed.py``), so
the copy of batch N+1 overlaps the step computing batch N.
``iter_torch_batches`` keeps the reference's meaning: host tensors.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator

import ray_tpu_torch
from ray_tpu_torch.data.block import BlockAccessor, concat_blocks


def iter_batches_over_refs(ref_iter: Iterator[Any], *,
                           batch_size: int | None, batch_format: str,
                           drop_last: bool,
                           prefetch_batches: int = 1) -> Iterator[Any]:
    """Slice a stream of block refs into fixed-size batches, carrying
    remainders across block boundaries."""
    carry = None
    # Resolve a window of refs ahead so upstream tasks overlap consumption.
    window: collections.deque = collections.deque()

    def fill(it):
        while len(window) < 1 + max(0, prefetch_batches):
            try:
                window.append(next(it))
            except StopIteration:
                return False
        return True

    it = iter(ref_iter)
    while True:
        fill(it)
        if not window:
            break
        block = ray_tpu_torch.get(window.popleft())
        if block.num_rows == 0:
            continue
        if carry is not None:
            block = concat_blocks([carry, block])
            carry = None
        if batch_size is None:
            yield BlockAccessor(block).to_batch(batch_format)
            continue
        n = block.num_rows
        start = 0
        while n - start >= batch_size:
            yield BlockAccessor(
                block.slice(start, batch_size)).to_batch(batch_format)
            start += batch_size
        if start < n:
            carry = block.slice(start, n - start)
    if carry is not None and carry.num_rows and not drop_last:
        yield BlockAccessor(carry).to_batch(batch_format)


def iter_device_batches_over_refs(ref_iter: Iterator[Any], *,
                                  batch_size: int, drop_last: bool,
                                  device=None, mesh=None,
                                  dtypes: dict | None = None
                                  ) -> Iterator[dict]:
    """Double-buffered device feed: the counterpart of the reference's
    ``iter_jax_batches_over_refs``.

    Each yielded batch is a dict of tensors already on ``device`` (the
    current card when None), or, with ``mesh``, DTensors placed as
    ``shard_batch`` places a host batch (leading dim over dp/fsdp, the
    sequence dim over sp). ``dtypes`` casts columns in numpy before the
    copy. The next batch's copy is issued before the current one is
    yielded. ``device="cpu"`` gives plain ``torch.from_numpy`` tensors.
    The device is resolved here, so a call without a card raises at
    once unless it asks for the CPU.
    """
    import torch

    from ray_tpu_torch._private.device import resolve_device
    from ray_tpu_torch.data._device_feed import stage_batches

    if mesh is not None:
        if device is not None and \
                torch.device(device).type != mesh.device_type:
            raise ValueError(f"device {device!r} is not the mesh's "
                             f"{mesh.device_type!r}")
        device = mesh.device_type
    device = resolve_device(device)
    host_iter = iter_batches_over_refs(
        ref_iter, batch_size=batch_size, batch_format="numpy",
        drop_last=drop_last, prefetch_batches=2)
    batches = stage_batches(host_iter, device, dtypes)
    if mesh is None:
        return batches
    from ray_tpu_torch.parallel.train_step import shard_batch

    return (shard_batch(batch, mesh) for batch in batches)


class _SplitLane:
    """One consumer's bounded queue + abandonment flag."""

    def __init__(self, maxsize: int):
        import queue as queue_mod
        import threading

        self.queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=maxsize)
        self.abandoned = threading.Event()

    def drain(self) -> None:
        import queue as queue_mod

        try:
            while True:
                self.queue.get_nowait()
        except queue_mod.Empty:
            pass


class DataIterator:
    """One consumer's view of a shared streaming execution.

    Reference: python/ray/data/iterator.py DataIterator, as returned by
    Dataset.streaming_split — N training workers iterate concurrently
    while ONE upstream execution produces blocks.

    A consumer that stops early (break / exception) closes its lane
    (generator finally), so the shared distributor reroutes its share
    instead of blocking the other consumers forever.
    """

    def __init__(self, lane: _SplitLane, name: str):
        self._lane = lane
        self._name = name

    def close(self) -> None:
        """Abandon this split: remaining blocks go to other consumers."""
        self._lane.abandoned.set()
        self._lane.drain()

    def _ref_iter(self) -> Iterator[Any]:
        try:
            while True:
                item = self._lane.queue.get()
                if item is None:
                    return
                if isinstance(item, tuple) and len(item) == 2 \
                        and item[0] == "__split_error__":
                    raise item[1]
                yield item
        finally:
            # Early exit (consumer broke out) or normal end: either way
            # the distributor must not keep feeding this lane.
            self.close()

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_batches: int = 1) -> Iterator[Any]:
        return iter_batches_over_refs(
            self._ref_iter(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            prefetch_batches=prefetch_batches)

    def iter_rows(self) -> Iterator[dict]:
        for batch in self.iter_batches(batch_size=None,
                                       batch_format="pyarrow"):
            yield from batch.to_pylist()

    def iter_device_batches(self, *, batch_size: int = 256,
                            drop_last: bool = True, device=None, mesh=None,
                            dtypes: dict | None = None) -> Iterator[Any]:
        """``Dataset.iter_device_batches`` over this split."""
        return iter_device_batches_over_refs(
            self._ref_iter(), batch_size=batch_size, drop_last=drop_last,
            device=device, mesh=mesh, dtypes=dtypes)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False) -> Iterator[Any]:
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last):
            yield {k: torch.as_tensor(v) for k, v in batch.items()}

    def __repr__(self):
        return f"DataIterator({self._name})"


def streaming_split_iterators(ref_iter: Iterator[Any], n: int, *,
                              equal: bool = False,
                              max_queued_blocks: int = 4,
                              name: str = "split") -> list[DataIterator]:
    """Fan a stream of block refs out to n DataIterators.

    A distributor thread assigns each block to the consumer with the
    fewest assigned rows so far (``equal=True``: reads each block's
    row count via the in-process store — a dict lookup here, not a
    transfer) or round-robin. Bounded per-consumer queues backpressure
    the shared execution when any consumer lags; abandoned lanes
    (consumer stopped early) are rerouted, not waited on.
    """
    import queue as queue_mod
    import threading

    lanes = [_SplitLane(max_queued_blocks) for _ in range(n)]
    assigned_rows = [0] * n

    def offer(target: int, ref) -> bool:
        """Put to a lane; False if it is (or becomes) abandoned."""
        while not lanes[target].abandoned.is_set():
            try:
                lanes[target].queue.put(ref, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def distribute():
        # On an upstream task failure the error must reach every
        # consumer — a clean end-of-stream would silently truncate the
        # data (training on a partial dataset with no error).
        tail_item: list = [None]
        try:
            rr = 0
            for ref in ref_iter:
                placed = False
                while not placed:
                    live = [j for j in range(n)
                            if not lanes[j].abandoned.is_set()]
                    if not live:
                        return  # every consumer gone: stop executing
                    if equal:
                        target = min(live,
                                     key=lambda j: assigned_rows[j])
                        rows = ray_tpu_torch.get(ref).num_rows
                    else:
                        target = live[rr % len(live)]
                        rr += 1
                        rows = 0
                    placed = offer(target, ref)
                    if placed:
                        assigned_rows[target] += rows
        except BaseException as exc:  # noqa: BLE001 — fan the error out
            tail_item[0] = ("__split_error__", exc)
            raise
        finally:
            for lane in lanes:
                while not lane.abandoned.is_set():
                    try:
                        lane.queue.put(tail_item[0], timeout=0.2)
                        break
                    except queue_mod.Full:
                        continue

    threading.Thread(target=distribute, daemon=True,
                     name="data-split-distributor").start()
    return [DataIterator(lane, f"{name}[{i}/{n}]")
            for i, lane in enumerate(lanes)]
