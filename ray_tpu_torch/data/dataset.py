"""Dataset: the lazy, streaming dataset API (the port of
``ray_tpu/data/dataset.py``).

Reference: python/ray/data/dataset.py:142 (Dataset). Transforms append
logical ops; nothing executes until consumption (iter_batches / take /
materialize / write_*). Execution streams block tasks through the
port's runtime (executor.py) with operator fusion and bounded in-flight
work. ``iter_device_batches`` is the port's counterpart of the
reference's ``iter_jax_batches``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import pyarrow as pa

import ray_tpu_torch
from ray_tpu_torch.data.block import (
    Block,
    BlockAccessor,
    concat_blocks,
    split_block,
)
from ray_tpu_torch.data.executor import (
    ExecutionContext,
    default_reduce,
    iter_block_refs,
    run_exchange,
)
from ray_tpu_torch.data.plan import (
    AllToAll,
    InputData,
    Limit,
    LogicalOp,
    MapBlocks,
)


class Dataset:
    """A lazy distributed dataset of Arrow blocks."""

    def __init__(self, ops: list[LogicalOp], name: str = "dataset"):
        self._ops = ops
        self._name = name
        self._shard_lock = threading.Lock()
        self._shard_refs_cache: list | None = None
        self._last_exec_ctx = None  # stats of the most recent execution
        self._exec_options: dict = {}

    # ------------------------------------------------------------ transforms

    def _with(self, op: LogicalOp, name: str) -> "Dataset":
        out = Dataset(self._ops + [op], name=name)
        out._exec_options = dict(self._exec_options)
        return out

    def execution_options(self, *, max_in_flight: int | None = None,
                          per_op_caps: dict[str, int] | None = None,
                          policies: list | None = None) -> "Dataset":
        """Per-dataset execution knobs (reference: per-operator resource
        limits + backpressure_policy/): ``per_op_caps`` bounds how many
        block tasks a named operator keeps in flight, ``policies`` adds
        custom BackpressurePolicy objects."""
        out = Dataset(self._ops, name=self._name)
        out._exec_options = dict(self._exec_options)
        if max_in_flight is not None:
            out._exec_options["max_in_flight"] = max_in_flight
        if per_op_caps is not None:
            out._exec_options["per_op_caps"] = dict(per_op_caps)
        if policies is not None:
            out._exec_options["policies"] = list(policies)
        return out

    def map(self, fn: Callable[[dict], dict]) -> "Dataset":
        """Row transform (reference: dataset.map)."""

        def map_block(block: Block) -> Block:
            rows = [fn(row) for row in BlockAccessor(block).iter_rows()]
            return BlockAccessor.rows_to_block(rows)

        return self._with(MapBlocks(map_block, name="Map", row_preserving=True), "map")

    def map_batches(self, fn: Callable, *, batch_size: int | None = None,
                    batch_format: str = "numpy",
                    fn_kwargs: dict | None = None) -> "Dataset":
        """Batch transform (reference: dataset.map_batches) — the hot
        path: numpy batches in, numpy batches out, vectorized."""
        fn_kwargs = fn_kwargs or {}

        def map_block(block: Block) -> Block:
            acc = BlockAccessor(block)
            out_blocks = []
            n = acc.num_rows()
            step = batch_size or max(n, 1)
            for start in range(0, max(n, 1), step):
                sub = BlockAccessor(acc.slice(start, min(start + step, n)))
                result = fn(sub.to_batch(batch_format), **fn_kwargs)
                out_blocks.append(BlockAccessor.batch_to_block(result))
            return concat_blocks(out_blocks) if out_blocks else block

        return self._with(MapBlocks(map_block, name="MapBatches"),
                          "map_batches")

    def flat_map(self, fn: Callable[[dict], Iterable[dict]]) -> "Dataset":
        def map_block(block: Block) -> Block:
            rows: list[dict] = []
            for row in BlockAccessor(block).iter_rows():
                rows.extend(fn(row))
            return BlockAccessor.rows_to_block(rows)

        return self._with(MapBlocks(map_block, name="FlatMap"), "flat_map")

    def filter(self, fn: Callable[[dict], bool]) -> "Dataset":
        def map_block(block: Block) -> Block:
            mask = [fn(row) for row in BlockAccessor(block).iter_rows()]
            return block.filter(pa.array(mask, type=pa.bool_()))

        return self._with(MapBlocks(map_block, name="Filter"), "filter")

    def add_column(self, name: str, fn: Callable[[dict], Any]) -> "Dataset":
        def map_block(block: Block) -> Block:
            values = [fn(row) for row in BlockAccessor(block).iter_rows()]
            return block.append_column(name, pa.array(values))

        return self._with(MapBlocks(map_block, name="AddColumn", row_preserving=True), "add_column")

    def drop_columns(self, cols: list[str]) -> "Dataset":
        return self._with(
            MapBlocks(lambda b: b.drop_columns(cols), name="DropColumns",
                      row_preserving=True),
            "drop_columns")

    def select_columns(self, cols: list[str]) -> "Dataset":
        return self._with(
            MapBlocks(lambda b: b.select(cols), name="SelectColumns",
                      row_preserving=True, kind="project",
                      cols=list(cols)),
            "select_columns")

    def rename_columns(self, mapping: dict[str, str]) -> "Dataset":
        def map_block(block: Block) -> Block:
            return block.rename_columns(
                [mapping.get(c, c) for c in block.column_names])

        return self._with(MapBlocks(map_block, name="Rename", row_preserving=True), "rename")

    def limit(self, n: int) -> "Dataset":
        return self._with(Limit(limit=n), f"limit({n})")

    # ----------------------------------------------------------- all-to-all

    def repartition(self, num_blocks: int) -> "Dataset":
        """Reference: dataset.repartition (exchange-based)."""

        def partition(b: Block, n: int, idx: int) -> list[Block]:
            # Rotate the split->partition assignment by the block index:
            # split_block floor-biases remainder rows toward the tail,
            # and without rotation every small block sends its rows to
            # the SAME partition (e.g. 100 one-row blocks -> one
            # 100-row partition + n-1 empties).
            parts = split_block(b, n)
            k = idx % n
            return parts[n - k:] + parts[:n - k]

        def do(block_refs: list, ctx) -> list:
            return run_exchange(
                block_refs,
                partition_fn=partition,
                reduce_fn=default_reduce,
                num_partitions=num_blocks)

        return self._with(AllToAll(do, name="Repartition"), "repartition")

    def random_shuffle(self, *, seed: int | None = None,
                       num_blocks: int | None = None) -> "Dataset":
        """Reference: dataset.random_shuffle → push-based shuffle exchange."""

        def do(block_refs: list, ctx) -> list:
            nparts = num_blocks or max(1, len(block_refs))
            # Unseeded shuffles draw fresh OS entropy per execution so each
            # epoch reshuffles; seeded shuffles are deterministic.
            rng_seed = (seed if seed is not None
                        else np.random.SeedSequence().entropy % (2 ** 31))

            def partition(block: Block, n: int, idx: int) -> list[Block]:
                rng = np.random.default_rng((rng_seed, idx))
                perm = rng.permutation(block.num_rows)
                shuffled = BlockAccessor(block).take_rows(perm)
                return split_block(shuffled, n)

            def reduce(parts: list[Block]) -> Block:
                merged = concat_blocks(parts)
                rng = np.random.default_rng((rng_seed, merged.num_rows, 1))
                return BlockAccessor(merged).take_rows(
                    rng.permutation(merged.num_rows))

            return run_exchange(block_refs, partition, reduce, nparts)

        return self._with(AllToAll(do, name="RandomShuffle"),
                          "random_shuffle")

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        """Sample-partition-merge sort (reference: planner/exchange/
        sort_task_spec.py)."""

        def do(block_refs: list, ctx) -> list:
            nparts = max(1, len(block_refs))
            if not block_refs:
                return []
            # Sample boundaries from the first block.
            sample = ray_tpu_torch.get(block_refs[0])
            col = BlockAccessor(sample).to_numpy().get(key)
            if col is None or len(col) == 0:
                boundaries = np.array([])
            else:
                qs = np.linspace(0, 100, nparts + 1)[1:-1]
                boundaries = np.percentile(col, qs) if len(qs) else np.array([])

            def partition(block: Block, n: int, _bi: int) -> list[Block]:
                vals = BlockAccessor(block).to_numpy()[key]
                idx = np.searchsorted(boundaries, vals) if len(boundaries) \
                    else np.zeros(len(vals), dtype=int)
                return [BlockAccessor(block).take_rows(
                    np.nonzero(idx == i)[0]) for i in range(n)]

            def reduce(parts: list[Block]) -> Block:
                merged = concat_blocks(parts)
                vals = BlockAccessor(merged).to_numpy()[key]
                order = np.argsort(vals, kind="stable")
                if descending:
                    order = order[::-1]
                return BlockAccessor(merged).take_rows(order)

            parts = run_exchange(block_refs, partition, reduce, nparts)
            return parts if not descending else list(reversed(parts))

        return self._with(AllToAll(do, name="Sort"), f"sort({key})")

    def groupby(self, key: str) -> "GroupedData":
        from ray_tpu_torch.data.grouped import GroupedData

        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        def do(block_refs: list, ctx) -> list:
            out = list(block_refs)
            for other in others:
                out.extend(other._block_refs())
            return out

        return self._with(AllToAll(do, name="Union"), "union")

    def zip(self, other: "Dataset") -> "Dataset":
        def do(block_refs: list, ctx) -> list:
            left = concat_blocks([ray_tpu_torch.get(r) for r in block_refs])
            right = concat_blocks([ray_tpu_torch.get(r) for r in other._block_refs()])
            if left.num_rows != right.num_rows:
                raise ValueError(
                    f"zip requires equal row counts: {left.num_rows} vs "
                    f"{right.num_rows}")
            for name in right.column_names:
                out_name = name if name not in left.column_names else name + "_1"
                left = left.append_column(out_name, right.column(name))
            return [ray_tpu_torch.put(left)]

        return self._with(AllToAll(do, name="Zip"), "zip")

    def random_sample(self, fraction: float, *, seed: int | None = None) -> "Dataset":
        # Salt the seed per block so blocks draw independent Bernoulli
        # streams (same pattern as random_shuffle's per-partition rng).
        base = (seed if seed is not None
                else np.random.SeedSequence().entropy % (2 ** 31))

        def map_block(block: Block, idx: int) -> Block:
            rng = np.random.default_rng((base, idx))
            mask = rng.random(block.num_rows) < fraction
            return block.filter(pa.array(mask))

        return self._with(
            MapBlocks(map_block, name="RandomSample", needs_index=True),
            "random_sample")

    # ----------------------------------------------------------- consumption

    def _block_ref_iter(self) -> Iterator[Any]:
        from ray_tpu_torch.data.executor import ExecutionContext

        ctx = ExecutionContext(**self._exec_options)
        self._last_exec_ctx = ctx
        return iter_block_refs(self._ops, ctx)

    def _block_refs(self) -> list[Any]:
        return list(self._block_ref_iter())

    def materialize(self) -> "Dataset":
        """Execute now; result holds block refs (reference:
        dataset.materialize → MaterializedDataset)."""
        refs = self._block_refs()
        return Dataset([InputData(block_refs=refs)],
                       name=f"{self._name}(materialized)")

    def count(self) -> int:
        return sum(ray_tpu_torch.get(r).num_rows for r in self._block_ref_iter())

    def schema(self) -> pa.Schema | None:
        for ref in self._block_ref_iter():
            return ray_tpu_torch.get(ref).schema
        return None

    def columns(self) -> list[str]:
        s = self.schema()
        return list(s.names) if s is not None else []

    def num_blocks(self) -> int:
        return len(self._block_refs())

    def size_bytes(self) -> int:
        return sum(ray_tpu_torch.get(r).nbytes for r in self._block_ref_iter())

    def take(self, limit: int = 20) -> list[dict]:
        rows: list[dict] = []
        for ref in self._block_ref_iter():
            for row in BlockAccessor(ray_tpu_torch.get(ref)).iter_rows():
                rows.append(row)
                if len(rows) >= limit:
                    return rows
        return rows

    def take_all(self) -> list[dict]:
        rows: list[dict] = []
        for ref in self._block_ref_iter():
            rows.extend(BlockAccessor(ray_tpu_torch.get(ref)).iter_rows())
        return rows

    def take_batch(self, batch_size: int = 20,
                   batch_format: str = "numpy"):
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format=batch_format):
            return batch
        return {}

    def show(self, limit: int = 20) -> None:
        for row in self.take(limit):
            print(row)

    def iter_rows(self) -> Iterator[dict]:
        for ref in self._block_ref_iter():
            yield from BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()

    def iter_batches(self, *, batch_size: int | None = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     prefetch_batches: int = 1) -> Iterator[Any]:
        from ray_tpu_torch.data.iterator import iter_batches_over_refs

        return iter_batches_over_refs(
            self._block_ref_iter(), batch_size=batch_size,
            batch_format=batch_format, drop_last=drop_last,
            prefetch_batches=prefetch_batches)

    def iter_device_batches(self, *, batch_size: int = 256,
                            drop_last: bool = True, device=None, mesh=None,
                            dtypes: dict | None = None) -> Iterator[dict]:
        """Batches as dicts of tensors already on the card, staged one
        batch ahead (the counterpart of the reference's
        ``iter_jax_batches``; see iterator.py). ``mesh`` places each batch
        as ``shard_batch`` does; ``device="cpu"`` gives plain CPU
        tensors. Raises at once when there is no card and the caller did
        not ask for the CPU."""
        from ray_tpu_torch.data.iterator import iter_device_batches_over_refs

        return iter_device_batches_over_refs(
            self._block_ref_iter(), batch_size=batch_size,
            drop_last=drop_last, device=device, mesh=mesh, dtypes=dtypes)

    def iter_torch_batches(self, *, batch_size: int = 256,
                           drop_last: bool = False) -> Iterator[dict]:
        import torch

        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            yield {k: torch.as_tensor(v) for k, v in batch.items()}

    # ------------------------------------------------------------- reshaping

    def split(self, n: int, *, equal: bool = False) -> list["Dataset"]:
        """Split into n datasets by block (reference: dataset.split)."""
        refs = self._block_refs()
        if equal or len(refs) < n:
            block = concat_blocks([ray_tpu_torch.get(r) for r in refs])
            parts = split_block(block, n)
            return [Dataset([InputData(block_refs=[ray_tpu_torch.put(p)])],
                            name=f"{self._name}.split[{i}]")
                    for i, p in enumerate(parts)]
        out: list[list] = [[] for _ in range(n)]
        for i, ref in enumerate(refs):
            out[i % n].append(ref)
        return [Dataset([InputData(block_refs=part)],
                        name=f"{self._name}.split[{i}]")
                for i, part in enumerate(out)]

    def streaming_split(self, n: int, *, equal: bool = False,
                        max_queued_blocks: int = 4) -> list:
        """n DataIterators over ONE shared streaming execution
        (reference: dataset.streaming_split — the per-worker ingestion
        path of distributed trainers).

        Unlike ``split`` (materializes, then partitions), the upstream
        pipeline runs once, streaming; bounded per-consumer queues
        backpressure it when any consumer lags. ``equal=True`` balances
        by rows (greedy least-loaded) instead of round-robin.
        """
        from ray_tpu_torch.data.iterator import streaming_split_iterators

        return streaming_split_iterators(
            self._block_ref_iter(), n, equal=equal,
            max_queued_blocks=max_queued_blocks, name=self._name)

    def shard(self, num_shards: int, index: int) -> "Dataset":
        """Deterministic shard for per-worker ingestion (reference:
        dataset.split + train data_config).

        The pipeline executes ONCE per Dataset object (block refs are
        cached under a lock), so N workers sharding the same dataset do
        not re-run reads N times; each shard holds only its own block
        refs — the full dataset is never concatenated.
        """
        if not 0 <= index < num_shards:
            raise ValueError(f"shard index {index} out of [0, {num_shards})")
        with self._shard_lock:
            if self._shard_refs_cache is None:
                self._shard_refs_cache = self._block_refs()
        refs = self._shard_refs_cache
        if len(refs) >= num_shards:
            mine = refs[index::num_shards]
        else:
            # Fewer blocks than shards: row-split each block and take the
            # index-th slice of each, keeping per-worker memory at 1/N.
            mine = []
            for ref in refs:
                part = split_block(ray_tpu_torch.get(ref), num_shards)[index]
                if part.num_rows:
                    mine.append(ray_tpu_torch.put(part))
        return Dataset([InputData(block_refs=mine)],
                       name=f"{self._name}.shard[{index}/{num_shards}]")

    def train_test_split(self, test_size: float, *, shuffle: bool = False,
                         seed: int | None = None):
        ds = self.random_shuffle(seed=seed) if shuffle else self
        rows = ds.take_all()
        cut = int(len(rows) * (1 - test_size))
        from ray_tpu_torch.data.read_api import from_items

        return from_items(rows[:cut]), from_items(rows[cut:])

    # ---------------------------------------------------------------- output

    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq
        import os

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._block_ref_iter()):
            pq.write_table(ray_tpu_torch.get(ref), f"{path}/part-{i:05d}.parquet")

    def write_csv(self, path: str) -> None:
        from pyarrow import csv as pacsv
        import os

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._block_ref_iter()):
            pacsv.write_csv(ray_tpu_torch.get(ref), f"{path}/part-{i:05d}.csv")

    def write_numpy(self, path: str, *, column: str) -> None:
        """One .npy file per block from ``column`` (reference:
        dataset.write_numpy)."""
        import os

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._block_ref_iter()):
            batch = BlockAccessor(ray_tpu_torch.get(ref)).to_numpy()
            if column not in batch:
                raise KeyError(
                    f"write_numpy: column {column!r} not in "
                    f"{sorted(batch)}")
            np.save(f"{path}/part-{i:05d}.npy", batch[column])

    def write_json(self, path: str) -> None:
        import json
        import os

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._block_ref_iter()):
            rows = BlockAccessor(ray_tpu_torch.get(ref)).iter_rows()
            with open(f"{path}/part-{i:05d}.json", "w") as f:
                for row in rows:
                    f.write(json.dumps(_json_safe(row)) + "\n")

    def to_pandas(self):
        return concat_blocks(
            [ray_tpu_torch.get(r) for r in self._block_ref_iter()]).to_pandas()

    def to_arrow(self) -> pa.Table:
        return concat_blocks([ray_tpu_torch.get(r) for r in self._block_ref_iter()])

    # ----------------------------------------------------------------- stats

    def stats(self) -> str:
        """Execution stats of the most recent run (reference:
        Dataset.stats / _internal/stats.py)."""
        header = (f"Dataset(name={self._name!r}, "
                  f"stages={[op.name for op in self._ops]})")
        if self._last_exec_ctx is None:
            return header + "\n  (not executed yet)"
        return header + "\n" + self._last_exec_ctx.stats.summary()

    def __repr__(self):
        return f"Dataset({self._name})"

    # ------------------------------------------------------------ aggregates

    def sum(self, on: str) -> float:
        return self._agg_column(on, np.sum)

    def min(self, on: str) -> float:
        return self._agg_column(on, np.min)

    def max(self, on: str) -> float:
        return self._agg_column(on, np.max)

    def mean(self, on: str) -> float:
        total, count = 0.0, 0
        for ref in self._block_ref_iter():
            col = BlockAccessor(ray_tpu_torch.get(ref)).to_numpy()[on]
            total += float(np.sum(col))
            count += len(col)
        return total / max(count, 1)

    def std(self, on: str) -> float:
        vals = np.concatenate([
            BlockAccessor(ray_tpu_torch.get(r)).to_numpy()[on]
            for r in self._block_ref_iter()])
        return float(np.std(vals, ddof=1))

    def unique(self, on: str) -> list:
        seen: set = set()
        for ref in self._block_ref_iter():
            seen.update(BlockAccessor(ray_tpu_torch.get(ref)).to_numpy()[on].tolist())
        return sorted(seen)

    def _agg_column(self, on: str, fn) -> float:
        partials = [
            fn(BlockAccessor(ray_tpu_torch.get(r)).to_numpy()[on])
            for r in self._block_ref_iter()]
        return float(fn(np.asarray(partials)))


def _json_safe(row: dict) -> dict:
    out = {}
    for k, v in row.items():
        if isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        elif isinstance(v, np.ndarray):
            out[k] = v.tolist()
        else:
            out[k] = v
    return out
