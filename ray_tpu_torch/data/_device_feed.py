"""Staging host batches on the card, one batch ahead.

The device half of ``iter_device_batches`` (the counterpart of the
reference's double-buffered ``jax.device_put`` in
``ray_tpu/data/iterator.py``). It imports numpy and torch only, so it
works where pyarrow is missing.

A batch is a dict of numpy arrays. Each column is cast in numpy (when
``dtypes`` names it), written into page-locked host memory, and copied
to the card with ``non_blocking=True`` on a side stream; an event is
recorded after the batch's copies. The next batch's copies are issued
before the current batch is handed out. A double buffer goes wrong in
two ways, and the design closes each:

- a batch read before its copy has landed: before a batch is yielded,
  the consumer's current stream waits on its copy event, so every
  kernel the consumer queues after ``next()`` sees the landed bytes;
- a buffer freed or reused under a copy still in flight: each pinned
  buffer is held until its copy's event has completed, and each device
  tensor (allocated on the side stream) is marked as used by the
  consumer's stream (``record_stream``), so the caching allocator does
  not hand its memory to the next copy while the consumer's kernels may
  still read it.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def host_array(value, dtype=None) -> np.ndarray:
    """``value`` as a C-contiguous numpy array, cast to ``dtype`` if
    given (in numpy, before any copy to the card)."""
    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(dtype)
    return np.ascontiguousarray(arr)


def stage_batches(host_batches: Iterable[dict], device: torch.device,
                  dtypes: dict | None = None) -> Iterator[dict]:
    """Yield each host batch as a dict of tensors on ``device``: on
    ``cuda`` through the double buffer, on the CPU as plain
    ``torch.from_numpy`` tensors (no pinning, no streams)."""
    device = torch.device(device)
    dtypes = dict(dtypes or {})
    if device.type == "cpu":
        return ({k: _cpu_tensor(host_array(v, dtypes.get(k)))
                 for k, v in batch.items()} for batch in host_batches)
    if device.type != "cuda":
        raise ValueError(f"the device feed stages on 'cuda' or 'cpu', not "
                         f"{device}")
    return _double_buffered(iter(host_batches), device, dtypes)


def _cpu_tensor(arr: np.ndarray) -> torch.Tensor:
    # A read-only array (a zero-copy view of an Arrow column) is copied:
    # a tensor must never write into memory it does not own.
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _double_buffered(host_batches: Iterator[dict], device: torch.device,
                     dtypes: dict) -> Iterator[dict]:
    copy_stream = torch.cuda.Stream(device)
    # (copy event, pinned buffers) of copies not yet seen complete.
    in_flight: collections.deque = collections.deque()
    staged = None
    try:
        for host_batch in host_batches:
            nxt = _stage(host_batch, device, dtypes, copy_stream, in_flight)
            if staged is not None:
                yield _land(staged, device)
            staged = nxt
        if staged is not None:
            yield _land(staged, device)
    finally:
        for event, _ in in_flight:
            event.synchronize()
        in_flight.clear()


def _stage(host_batch: dict, device: torch.device, dtypes: dict,
           copy_stream: torch.cuda.Stream,
           in_flight: collections.deque) -> tuple[dict, torch.cuda.Event]:
    while in_flight and in_flight[0][0].query():
        in_flight.popleft()
    pinned = {}
    for key, value in host_batch.items():
        arr = host_array(value, dtypes.get(key))
        buf = torch.empty(arr.shape, dtype=_torch_dtype(arr.dtype),
                          pin_memory=True)
        np.copyto(buf.numpy(), arr)
        pinned[key] = buf
    with torch.cuda.stream(copy_stream):
        tensors = {key: buf.to(device, non_blocking=True)
                   for key, buf in pinned.items()}
        event = torch.cuda.Event()
        event.record(copy_stream)
    in_flight.append((event, list(pinned.values())))
    return tensors, event


def _land(staged: tuple[dict, torch.cuda.Event],
          device: torch.device) -> dict:
    tensors, event = staged
    consumer = torch.cuda.current_stream(device)
    consumer.wait_event(event)
    for tensor in tensors.values():
        tensor.record_stream(consumer)
    return tensors


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype
