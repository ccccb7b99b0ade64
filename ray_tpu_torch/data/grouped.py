"""GroupedData: hash-partitioned groupby + aggregations (the port of
``ray_tpu/data/grouped.py``).

Reference: python/ray/data/grouped_data.py. Implementation is a hash
exchange (group key → partition) followed by per-partition aggregation,
so each group lands wholly in one reduce task.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks
from ray_tpu_torch.data.executor import run_exchange
from ray_tpu_torch.data.plan import AllToAll


_AGGS: dict[str, Callable[[np.ndarray], float]] = {
    "sum": np.sum,
    "min": np.min,
    "max": np.max,
    "mean": np.mean,
    "count": len,
    "std": lambda v: np.std(v, ddof=1),
}


def _stable_hash(value) -> int:
    """Process-independent hash: Python's builtin hash() is salted per
    process for str/bytes, which would split groups across partitions if
    partition tasks run in different workers."""
    import zlib

    return zlib.crc32(repr(value).encode())


def _hash_partition(block: Block, n: int, key: str) -> list[Block]:
    vals = BlockAccessor(block).to_numpy()[key]
    hashes = np.array([_stable_hash(v) % n for v in vals.tolist()])
    return [BlockAccessor(block).take_rows(np.nonzero(hashes == i)[0])
            for i in range(n)]


class GroupedData:
    def __init__(self, dataset, key: str):
        self._dataset = dataset
        self._key = key

    def _aggregate(self, specs: list[tuple[str, str]], out_names: list[str]):
        """specs: [(agg_name, column)] applied per group."""
        key = self._key

        def do(block_refs: list, ctx) -> list:
            nparts = max(1, len(block_refs))

            def partition(block: Block, n: int, _bi: int) -> list[Block]:
                return _hash_partition(block, n, key)

            def reduce(parts: list[Block]) -> Block:
                merged = concat_blocks(parts)
                if merged.num_rows == 0:
                    return pa.table({})
                cols = BlockAccessor(merged).to_numpy()
                keys = cols[key]
                order = np.argsort(keys, kind="stable")
                keys_sorted = keys[order]
                uniq, starts = np.unique(keys_sorted, return_index=True)
                out: dict[str, list] = {key: uniq.tolist()}
                for (agg, col), out_name in zip(specs, out_names):
                    fn = _AGGS[agg]
                    vals = cols[col][order] if col else None
                    results = []
                    bounds = list(starts) + [len(keys_sorted)]
                    for i in range(len(uniq)):
                        seg = (vals[bounds[i]:bounds[i + 1]]
                               if vals is not None
                               else keys_sorted[bounds[i]:bounds[i + 1]])
                        results.append(float(fn(seg)) if agg != "count"
                                       else int(len(seg)))
                    out[out_name] = results
                return pa.table({k: pa.array(v) for k, v in out.items()})

            return run_exchange(block_refs, partition, reduce, nparts)

        from ray_tpu_torch.data.dataset import Dataset

        return Dataset(
            self._dataset._ops + [AllToAll(do, name="GroupByAggregate")],
            name=f"groupby({key})")

    def sum(self, on: str):
        return self._aggregate([("sum", on)], [f"sum({on})"])

    def min(self, on: str):
        return self._aggregate([("min", on)], [f"min({on})"])

    def max(self, on: str):
        return self._aggregate([("max", on)], [f"max({on})"])

    def mean(self, on: str):
        return self._aggregate([("mean", on)], [f"mean({on})"])

    def std(self, on: str):
        return self._aggregate([("std", on)], [f"std({on})"])

    def count(self):
        return self._aggregate([("count", None)], ["count()"])

    def aggregate(self, **named_specs: tuple[str, str]):
        """aggregate(total=("sum", "x"), biggest=("max", "y"))"""
        specs = [v for v in named_specs.values()]
        return self._aggregate(specs, list(named_specs.keys()))

    def map_groups(self, fn: Callable[[dict], Any]):
        """Apply fn to each group's numpy batch (reference:
        grouped_data.map_groups)."""
        key = self._key

        def do(block_refs: list, ctx) -> list:
            nparts = max(1, len(block_refs))

            def partition(block: Block, n: int, _bi: int) -> list[Block]:
                return _hash_partition(block, n, key)

            def reduce(parts: list[Block]) -> Block:
                merged = concat_blocks(parts)
                if merged.num_rows == 0:
                    return pa.table({})
                cols = BlockAccessor(merged).to_numpy()
                keys = cols[key]
                order = np.argsort(keys, kind="stable")
                keys_sorted = keys[order]
                uniq, starts = np.unique(keys_sorted, return_index=True)
                bounds = list(starts) + [len(keys_sorted)]
                out_blocks = []
                for i in range(len(uniq)):
                    seg_idx = order[bounds[i]:bounds[i + 1]]
                    group_batch = {k: v[seg_idx] for k, v in cols.items()}
                    result = fn(group_batch)
                    out_blocks.append(BlockAccessor.batch_to_block(result))
                return concat_blocks(out_blocks)

            return run_exchange(block_refs, partition, reduce, nparts)

        from ray_tpu_torch.data.dataset import Dataset

        return Dataset(
            self._dataset._ops + [AllToAll(do, name="MapGroups")],
            name=f"map_groups({key})")
