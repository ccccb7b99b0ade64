"""Streaming execution of a data plan over the port's task runtime (the
port of ``ray_tpu/data/executor.py``). Block tasks run on driver threads,
or in pool processes under ``init(process_workers=N)``; user functions
cross to a pool process by value through the port's own pickler.

Reference: python/ray/data/_internal/execution/streaming_executor.py:55 —
the reference runs operators as a streaming topology with bounded
in-flight work (backpressure_policy/). This executor keeps the same two
properties with much less machinery:

- **streaming**: block refs are yielded as tasks finish; a consumer
  iterating batches overlaps with upstream reads/maps still running.
- **bounded in-flight window**: at most ``max_in_flight`` block tasks are
  outstanding per stage, so a huge dataset never floods the scheduler or
  the object store (the backpressure role of resource_manager.py).

All-to-all ops (shuffle/sort/repartition/groupby) are barriers executed
via a split/merge exchange (reference: _internal/planner/exchange/).
"""

from __future__ import annotations

import collections
from typing import Any, Iterator

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, concat_blocks
from ray_tpu_torch.data.optimizer import optimize
from ray_tpu_torch.data.plan import (
    AllToAll,
    InputData,
    Limit,
    LogicalOp,
    MapBlocks,
)


class StageStats:
    """Per-operator execution accounting (reference:
    _internal/stats.py DatasetStats)."""

    def __init__(self, name: str):
        self.name = name
        self.num_blocks = 0
        self.wall_s = 0.0
        self.backpressure_waits = 0


class ExecutionStats:
    def __init__(self):
        self.stages: list[StageStats] = []
        self.started_at: float | None = None
        self.finished_at: float | None = None
        self.applied_rules: list[str] = []  # optimizer rewrites

    def stage(self, name: str) -> StageStats:
        st = StageStats(name)
        self.stages.append(st)
        return st

    def summary(self) -> str:
        lines = ["Execution stats:"]
        if self.applied_rules:
            lines.append("  optimizer: " + ", ".join(self.applied_rules))
        for st in self.stages:
            line = (f"  {st.name}: {st.num_blocks} blocks, "
                    f"{st.wall_s:.3f}s wall")
            if st.backpressure_waits:
                line += f", {st.backpressure_waits} backpressure waits"
            lines.append(line)
        if self.started_at is not None and self.finished_at is not None:
            lines.append(
                f"  total: {self.finished_at - self.started_at:.3f}s")
        return "\n".join(lines)


class ExecutionContext:
    """Knobs + stats shared by stages; carried into AllToAll fns.

    ``policies`` are BackpressurePolicy objects consulted before an
    operator grows its in-flight window; ``per_op_caps`` is sugar for a
    ConcurrencyCapBackpressurePolicy (reference: per-operator resource
    limits + backpressure_policy/)."""

    def __init__(self, max_in_flight: int = 16,
                 policies: list | None = None,
                 per_op_caps: dict[str, int] | None = None):
        from ray_tpu_torch.data.backpressure import (
            ConcurrencyCapBackpressurePolicy,
            default_policies,
        )

        self.max_in_flight = max_in_flight
        self.policies = (list(policies) if policies is not None
                         else default_policies())
        if per_op_caps:
            self.policies.append(
                ConcurrencyCapBackpressurePolicy(per_op_caps))
        self.stats = ExecutionStats()

    def can_add_input(self, op_name: str, in_flight: int) -> bool:
        return all(p.can_add_input(op_name, in_flight)
                   for p in self.policies)


@ray_tpu_torch.remote
def _run_read(read_fn) -> Block:
    return read_fn()


@ray_tpu_torch.remote
def _run_chain(block: Block, fn) -> Block:
    return fn(block)


@ray_tpu_torch.remote
def _run_chain_idx(block: Block, fn, idx: int) -> Block:
    return fn(block, idx)


@ray_tpu_torch.remote
def _run_read_chain(read_fn, fn) -> Block:
    return fn(read_fn())


@ray_tpu_torch.remote
def _run_read_chain_idx(read_fn, fn, idx: int) -> Block:
    return fn(read_fn(), idx)


def iter_block_refs(ops: list[LogicalOp],
                    ctx: ExecutionContext | None = None) -> Iterator[Any]:
    """Stream block refs through the fused plan, preserving block order."""
    ctx = ctx or ExecutionContext()
    ops, applied_rules = optimize(ops)
    ctx.stats.applied_rules = applied_rules
    assert ops and isinstance(ops[0], InputData), "plan must start with Input"
    source: InputData = ops[0]
    stages = ops[1:]

    # A leading MapBlocks fuses into the read task itself (read fusion).
    read_fused = None
    read_fused_needs_index = False
    if stages and isinstance(stages[0], MapBlocks) and source.read_tasks:
        read_fused = stages[0].fn
        read_fused_needs_index = stages[0].needs_index
        stages = stages[1:]

    read_name = "read" + (f"+{read_fused.__name__}" if read_fused
                          and hasattr(read_fused, "__name__") else "")

    def input_stream() -> Iterator[Any]:
        import time as _time

        st = ctx.stats.stage(read_name if source.read_tasks else "input")
        if ctx.stats.started_at is None:
            ctx.stats.started_at = _time.perf_counter()
        t0 = _time.perf_counter()
        try:
            if source.read_tasks is not None:
                in_flight: collections.deque = collections.deque()
                for task_idx, task in enumerate(source.read_tasks):
                    # Backpressure: drain before submitting when any
                    # policy (store memory, per-op caps) says stop.
                    while in_flight and not ctx.can_add_input(
                            "read", len(in_flight)):
                        st.backpressure_waits += 1
                        st.num_blocks += 1
                        yield in_flight.popleft()
                    if read_fused is not None and read_fused_needs_index:
                        ref = _run_read_chain_idx.remote(
                            task.fn, read_fused, task_idx)
                    elif read_fused is not None:
                        ref = _run_read_chain.remote(task.fn, read_fused)
                    else:
                        ref = _run_read.remote(task.fn)
                    in_flight.append(ref)
                    if len(in_flight) >= ctx.max_in_flight:
                        st.num_blocks += 1
                        yield in_flight.popleft()
                while in_flight:
                    st.num_blocks += 1
                    yield in_flight.popleft()
            else:
                for ref in (source.block_refs or []):
                    st.num_blocks += 1
                    yield ref
        finally:
            # finally: early-terminated consumption (limit/take) must
            # still record real wall time, not 0.
            st.wall_s = _time.perf_counter() - t0
            ctx.stats.finished_at = _time.perf_counter()

    stream: Iterator[Any] = input_stream()
    for op in stages:
        if isinstance(op, MapBlocks):
            stream = _map_stage(stream, op, ctx)
        elif isinstance(op, AllToAll):
            stream = iter(op.fn(list(stream), ctx))
        elif isinstance(op, Limit):
            stream = _limit_stage(stream, op.limit)
        else:
            raise TypeError(f"Unknown op {op!r}")
    return stream


def _map_stage(upstream: Iterator[Any], op: MapBlocks,
               ctx: ExecutionContext) -> Iterator[Any]:
    import time as _time

    st = ctx.stats.stage(op.name)
    t0 = _time.perf_counter()
    try:
        in_flight: collections.deque = collections.deque()
        for idx, ref in enumerate(upstream):
            while in_flight and not ctx.can_add_input(
                    op.name, len(in_flight)):
                st.backpressure_waits += 1
                st.num_blocks += 1
                yield in_flight.popleft()
            if op.needs_index:
                in_flight.append(_run_chain_idx.remote(ref, op.fn, idx))
            else:
                in_flight.append(_run_chain.remote(ref, op.fn))
            if len(in_flight) >= ctx.max_in_flight:
                st.num_blocks += 1
                yield in_flight.popleft()
        while in_flight:
            st.num_blocks += 1
            yield in_flight.popleft()
    finally:
        st.wall_s = _time.perf_counter() - t0
        ctx.stats.finished_at = _time.perf_counter()


def _limit_stage(upstream: Iterator[Any], limit: int) -> Iterator[Any]:
    remaining = limit
    for ref in upstream:
        if remaining <= 0:
            return
        block: Block = ray_tpu_torch.get(ref)
        if block.num_rows <= remaining:
            remaining -= block.num_rows
            yield ref
        else:
            yield ray_tpu_torch.put(block.slice(0, remaining))
            remaining = 0
            return


def materialize_refs(ops: list[LogicalOp],
                     ctx: ExecutionContext | None = None) -> list[Any]:
    return list(iter_block_refs(ops, ctx))


# ------------------------------------------------------------------ exchange


@ray_tpu_torch.remote
def _partition_block(block: Block, partition_fn, num_partitions: int,
                     block_index: int):
    """Map side of an exchange: split one block into N partition blocks."""
    parts = partition_fn(block, num_partitions, block_index)
    assert len(parts) == num_partitions
    return tuple(parts) if num_partitions > 1 else parts[0]


@ray_tpu_torch.remote
def _merge_partition(reduce_fn, *parts: Block) -> Block:
    return reduce_fn(list(parts))


def run_exchange(block_refs: list[Any], partition_fn, reduce_fn,
                 num_partitions: int) -> list[Any]:
    """Split/merge exchange (reference: planner/exchange/
    shuffle_task_scheduler.py): every input block is partitioned, then
    partition i across all inputs is merged by one reduce task.

    ``partition_fn(block, num_partitions, block_index)`` — the index lets
    per-block randomness differ even for identically-sized blocks.
    """
    if not block_refs:
        return []
    split_refs = [
        _partition_block.options(num_returns=num_partitions).remote(
            ref, partition_fn, num_partitions, idx)
        for idx, ref in enumerate(block_refs)
    ]
    if num_partitions == 1:
        split_cols = [[r] if not isinstance(r, list) else r
                      for r in split_refs]
        return [_merge_partition.remote(reduce_fn,
                                        *[c[0] for c in split_cols])]
    out = []
    for i in range(num_partitions):
        parts_i = [splits[i] for splits in split_refs]
        out.append(_merge_partition.remote(reduce_fn, *parts_i))
    return out


def default_reduce(parts: list[Block]) -> Block:
    return concat_blocks(parts)
