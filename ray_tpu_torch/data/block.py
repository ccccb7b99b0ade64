"""Blocks: the unit of data in ray_tpu_torch.data.

The port of ``ray_tpu/data/block.py``. A block is a ``pyarrow.Table``
(reference: python/ray/data/block.py and arrow_block.py — blocks are
Arrow tables). ``BlockAccessor`` wraps one block with format conversions
and slicing; batches handed to user code are dicts of numpy arrays by
default (what the device feed copies to the card), with pandas/pyarrow
on request.

The tensor-column metadata key keeps the reference's bytes, so a parquet
file written by either package reads back the same in the other.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import pyarrow as pa

Block = pa.Table

# Batches move between user code and blocks in one of these formats.
BATCH_FORMATS = ("numpy", "pandas", "pyarrow", "default")


# Field-metadata key recording the per-row tensor shape of a
# FixedSizeList column, so N-d arrays round-trip through blocks intact.
TENSOR_SHAPE_META = b"ray_tpu.tensor_shape"


def _column_to_numpy(col: pa.ChunkedArray,
                     field: pa.Field | None = None) -> np.ndarray:
    """Convert an Arrow column to numpy, preserving tensor-shaped lists."""
    combined = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if pa.types.is_fixed_size_list(combined.type):
        flat = combined.flatten().to_numpy(zero_copy_only=False)
        shape: tuple = (combined.type.list_size,)
        if field is not None and field.metadata and \
                TENSOR_SHAPE_META in field.metadata:
            import json

            shape = tuple(json.loads(field.metadata[TENSOR_SHAPE_META]))
        return flat.reshape((len(combined),) + shape)
    if pa.types.is_list(combined.type) or pa.types.is_large_list(combined.type):
        return np.asarray(combined.to_pylist(), dtype=object)
    return combined.to_numpy(zero_copy_only=False)


def _numpy_to_column(arr: np.ndarray) -> tuple[pa.Array, dict | None]:
    """Returns (array, field_metadata or None)."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        return pa.array(arr), None
    if arr.ndim >= 2:
        # N-d tensors → FixedSizeList of flattened trailing dims per row,
        # with the true per-row shape in field metadata.
        import json

        inner = int(np.prod(arr.shape[1:]))
        flat = pa.array(arr.reshape(len(arr) * inner if len(arr) else 0,))
        meta = {TENSOR_SHAPE_META: json.dumps(list(arr.shape[1:])).encode()}
        return pa.FixedSizeListArray.from_arrays(flat, inner), meta
    return pa.array(arr.reshape(-1)), None


class BlockAccessor:
    """Format bridge for one block (reference: data/block.py BlockAccessor)."""

    def __init__(self, block: Block):
        self._block = block

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    # ------------------------------------------------------------- builders

    @staticmethod
    def batch_to_block(batch: Any) -> Block:
        """Anything user code returns from map_batches → a block."""
        if isinstance(batch, pa.Table):
            return batch
        if isinstance(batch, dict):
            cols, fields = [], []
            for name, values in batch.items():
                if isinstance(values, pa.Array):
                    cols.append(values)
                    fields.append(pa.field(name, values.type))
                else:
                    col, meta = _numpy_to_column(np.asarray(values))
                    cols.append(col)
                    fields.append(pa.field(name, col.type, metadata=meta))
            return pa.Table.from_arrays(cols, schema=pa.schema(fields))
        try:
            import pandas as pd

            if isinstance(batch, pd.DataFrame):
                return pa.Table.from_pandas(batch, preserve_index=False)
        except ImportError:
            pass
        raise TypeError(
            "map_batches must return a dict of arrays, a pyarrow.Table, or "
            f"a pandas.DataFrame; got {type(batch).__name__}")

    @staticmethod
    def rows_to_block(rows: list[dict]) -> Block:
        if not rows:
            return pa.table({})
        rows = [r if isinstance(r, dict) else {"item": r} for r in rows]
        # Union of keys across ALL rows (later rows may introduce columns);
        # missing values become nulls.
        keys: dict[str, None] = {}
        for row in rows:
            for k in row:
                keys.setdefault(k)
        cols: dict[str, list] = {k: [row.get(k) for row in rows]
                                 for k in keys}
        out_cols, out_fields = [], []
        for k, v in cols.items():
            if v and isinstance(v[0], np.ndarray):
                col, meta = _numpy_to_column(np.asarray(v))
            else:
                col, meta = pa.array(v), None
            out_cols.append(col)
            out_fields.append(pa.field(k, col.type, metadata=meta))
        return pa.Table.from_arrays(out_cols, schema=pa.schema(out_fields))

    # ------------------------------------------------------------ accessors

    def num_rows(self) -> int:
        return self._block.num_rows

    def size_bytes(self) -> int:
        return self._block.nbytes

    def schema(self) -> pa.Schema:
        return self._block.schema

    def slice(self, start: int, end: int) -> Block:
        return self._block.slice(start, end - start)

    def to_arrow(self) -> pa.Table:
        return self._block

    def to_pandas(self):
        return self._block.to_pandas()

    def to_numpy(self) -> dict[str, np.ndarray]:
        schema = self._block.schema
        return {name: _column_to_numpy(self._block.column(name),
                                       schema.field(name))
                for name in self._block.column_names}

    def to_batch(self, batch_format: str):
        if batch_format in ("numpy", "default"):
            return self.to_numpy()
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format == "pyarrow":
            return self._block
        raise ValueError(f"Unknown batch_format {batch_format!r}; "
                         f"expected one of {BATCH_FORMATS}")

    def iter_rows(self) -> Iterator[dict]:
        # Tensor columns must come back as shaped ndarrays, not the
        # flattened python lists to_pylist() would give.
        schema = self._block.schema
        tensor_cols = [f.name for f in schema
                       if f.metadata and TENSOR_SHAPE_META in f.metadata]
        if not tensor_cols:
            for batch in self._block.to_batches():
                yield from batch.to_pylist()
            return
        arrays = {name: _column_to_numpy(self._block.column(name),
                                         schema.field(name))
                  for name in tensor_cols}
        plain = self._block.drop_columns(tensor_cols)
        for i, row in enumerate(plain.to_pylist()):
            for name in tensor_cols:
                row[name] = arrays[name][i]
            yield row

    def take_rows(self, indices: np.ndarray) -> Block:
        return self._block.take(pa.array(indices))


def concat_blocks(blocks: list[Block]) -> Block:
    blocks = [b for b in blocks if b.num_rows > 0] or blocks[:1]
    if not blocks:
        return pa.table({})
    if len(blocks) == 1:
        return blocks[0]
    return pa.concat_tables(blocks, promote_options="default")


def split_block(block: Block, num_splits: int) -> list[Block]:
    n = block.num_rows
    if num_splits <= 1:
        return [block]
    bounds = np.linspace(0, n, num_splits + 1).astype(int)
    return [block.slice(bounds[i], bounds[i + 1] - bounds[i])
            for i in range(num_splits)]
