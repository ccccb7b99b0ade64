"""Creation/read APIs for ray_tpu_torch.data (the port of
``ray_tpu/data/read_api.py``). ``read_images`` (PIL), ``read_sql``
(the caller's DBAPI module) and ``from_huggingface`` (``datasets``)
need their library only when called.

Reference: python/ray/data/read_api.py + datasource/ connectors. Each
reader emits ``ReadTask``s (deferred, one block each) so reads execute
lazily inside the streaming plan, in parallel, with backpressure.
"""

from __future__ import annotations

import glob as glob_mod
import os
from builtins import range as builtins_range
from typing import Any, Callable

import numpy as np
import pyarrow as pa

from ray_tpu_torch.data.block import BlockAccessor
from ray_tpu_torch.data.plan import InputData, ReadTask


def _dataset(input_data, name: str):
    from ray_tpu_torch.data.dataset import Dataset

    return Dataset([input_data], name=name)


def range(n: int, *, override_num_blocks: int | None = None):  # noqa: A001
    """Dataset of {"id": 0..n-1} (reference: read_api.range)."""
    import builtins

    num_blocks = override_num_blocks or min(n, 200) or 1
    bounds = np.linspace(0, n, num_blocks + 1).astype(int)
    tasks = []
    for i in builtins.range(num_blocks):
        lo, hi = int(bounds[i]), int(bounds[i + 1])

        def read(lo=lo, hi=hi) -> pa.Table:
            return pa.table({"id": np.arange(lo, hi, dtype=np.int64)})

        tasks.append(ReadTask(read, {"num_rows": hi - lo}))
    return _dataset(InputData(read_tasks=tasks), f"range({n})")


def from_items(items: list, *, override_num_blocks: int | None = None):
    """Dataset from a list of dicts or scalars (reference:
    read_api.from_items)."""
    items = list(items)
    num_blocks = max(1, min(override_num_blocks or min(len(items), 200), max(len(items), 1)))
    bounds = np.linspace(0, len(items), num_blocks + 1).astype(int)
    tasks = []
    import builtins

    for i in builtins.range(num_blocks):
        chunk = items[int(bounds[i]):int(bounds[i + 1])]

        def read(chunk=chunk) -> pa.Table:
            return BlockAccessor.rows_to_block(
                [c if isinstance(c, dict) else {"item": c} for c in chunk])

        tasks.append(ReadTask(read, {"num_rows": len(chunk)}))
    return _dataset(InputData(read_tasks=tasks), "from_items")


def from_numpy(arrays: np.ndarray | dict[str, np.ndarray]):
    if isinstance(arrays, np.ndarray):
        arrays = {"data": arrays}

    def read() -> pa.Table:
        return BlockAccessor.batch_to_block(arrays)

    return _dataset(InputData(read_tasks=[ReadTask(read)]), "from_numpy")


def from_pandas(df) -> Any:
    def read() -> pa.Table:
        return pa.Table.from_pandas(df, preserve_index=False)

    return _dataset(InputData(read_tasks=[ReadTask(read)]), "from_pandas")


def from_arrow(table: pa.Table):
    return _dataset(InputData(read_tasks=[ReadTask(lambda: table)]),
                    "from_arrow")


def _expand_paths(paths: str | list[str], suffix: str | None) -> list[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            pattern = os.path.join(p, f"**/*{suffix or ''}")
            out.extend(sorted(glob_mod.glob(pattern, recursive=True)))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    files = [p for p in out if os.path.isfile(p)]
    if not files:
        raise FileNotFoundError(f"No input files found for {paths!r}")
    return files


def _file_reader(paths, suffix, parse: Callable[[str], pa.Table], name: str):
    files = _expand_paths(paths, suffix)
    tasks = [ReadTask((lambda f=f: parse(f)), {"path": f}) for f in files]
    return _dataset(InputData(read_tasks=tasks), name)


def read_parquet(paths: str | list[str], *, columns: list[str] | None = None):
    """Reference: read_api.read_parquet / datasource/parquet_datasource.py."""
    import pyarrow.parquet as pq

    return _file_reader(paths, ".parquet",
                        lambda f: pq.read_table(f, columns=columns),
                        "read_parquet")


def read_csv(paths: str | list[str], **csv_kwargs):
    from pyarrow import csv as pacsv

    return _file_reader(paths, ".csv", lambda f: pacsv.read_csv(f),
                        "read_csv")


def read_json(paths: str | list[str]):
    """Newline-delimited JSON (reference: datasource/json_datasource.py)."""
    from pyarrow import json as pajson

    return _file_reader(paths, ".json", lambda f: pajson.read_json(f),
                        "read_json")


def read_numpy(paths: str | list[str]):
    def parse(f: str) -> pa.Table:
        return BlockAccessor.batch_to_block({"data": np.load(f)})

    return _file_reader(paths, ".npy", parse, "read_numpy")


def read_binary_files(paths: str | list[str]):
    def parse(f: str) -> pa.Table:
        with open(f, "rb") as fh:
            return pa.table({"path": [f], "bytes": [fh.read()]})

    return _file_reader(paths, None, parse, "read_binary_files")


def read_text(paths: str | list[str]):
    def parse(f: str) -> pa.Table:
        with open(f) as fh:
            return pa.table({"text": [ln.rstrip("\n") for ln in fh]})

    return _file_reader(paths, None, parse, "read_text")


def read_images(paths: str | list[str], *, size: tuple | None = None,
                mode: str | None = None, include_paths: bool = False):
    """Image files -> {"image": HxWxC uint8 array} rows (reference:
    datasource/image_datasource.py). ``size`` resizes, ``mode``
    converts (e.g. "RGB", "L"); one file per block so decode runs
    inside the parallel read tasks, not on the driver."""
    def parse(f: str) -> pa.Table:
        from PIL import Image

        img = Image.open(f)
        if mode is not None:
            img = img.convert(mode)
        if size is not None:
            img = img.resize((size[1], size[0]))
        arr = np.asarray(img)
        cols = {"image": [arr]}
        if include_paths:
            cols["path"] = [f]
        return BlockAccessor.rows_to_block(
            [{k: v[0] for k, v in cols.items()}])

    return _file_reader(
        paths, None, parse, "read_images")


def read_sql(sql: str, connection_factory: Callable[[], Any], *,
             shard_keys: list | None = None, shard_column: str | None = None):
    """DBAPI-2 query -> Dataset (reference: read_api.read_sql /
    datasource/sql_datasource.py).

    ``connection_factory`` is a zero-arg callable returning a fresh
    DBAPI connection — it ships to the read tasks, so it must be
    picklable (import inside, e.g. ``lambda: sqlite3.connect(path)``).
    With ``shard_keys`` + ``shard_column``, one read task runs per key,
    filtering the user query AS A SUBQUERY (``SELECT * FROM ({sql})
    WHERE shard_column = ?``) so queries with their own WHERE / GROUP
    BY / ORDER BY stay valid — which means ``shard_column`` must appear
    in the query's output columns. Otherwise a single task runs the
    query as-is."""
    def run_query(query: str, params: tuple = ()) -> pa.Table:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(query, params)
            names = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        return BlockAccessor.rows_to_block(
            [dict(zip(names, r)) for r in rows]) if rows else pa.table(
                {n: [] for n in names})

    if shard_keys and shard_column:
        # Wrap as a subquery (reference: sql_datasource shards the same
        # way): appending WHERE to a query that already has its own
        # WHERE / GROUP BY / ORDER BY would be invalid SQL or silently
        # filter the wrong rows.
        # The derived table needs an alias: SQLite tolerates its absence
        # but PostgreSQL/MySQL reject it.
        sharded = (f"SELECT * FROM ({sql}) AS _sharded "  # noqa: S608
                   f"WHERE {shard_column} = ?")
        tasks = [ReadTask((lambda k=k: run_query(sharded, (k,))),
                          {"shard": k}) for k in shard_keys]
    else:
        tasks = [ReadTask(lambda: run_query(sql))]
    return _dataset(InputData(read_tasks=tasks), "read_sql")


def from_torch(dataset) -> Any:
    """torch.utils.data.Dataset -> Dataset of {"item": ...} rows
    (reference: read_api.from_torch).

    Map-style datasets (``__len__`` + ``__getitem__``) are indexed
    explicitly — plain ``for item in dataset`` would fall into the
    legacy iteration protocol, which ignores ``__len__`` and loops
    forever on datasets whose ``__getitem__`` never raises IndexError.
    Iterable-style datasets are consumed with ``iter()``.
    """
    def read() -> pa.Table:
        if hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__"):
            items = (dataset[i] for i in builtins_range(len(dataset)))
        else:
            items = iter(dataset)
        rows = [item if isinstance(item, dict) else {"item": item}
                for item in items]
        return BlockAccessor.rows_to_block(rows)

    return _dataset(InputData(read_tasks=[ReadTask(read)]), "from_torch")


def from_huggingface(dataset) -> Any:
    """datasets.Dataset -> Dataset (reference:
    read_api.from_huggingface; zero-copy via the underlying Arrow
    table, one block per record batch)."""
    table = dataset.data.table if hasattr(dataset, "data") else None
    if table is None:
        raise ValueError(
            "from_huggingface expects a datasets.Dataset (a "
            "DatasetDict must be indexed by split first)")
    batches = table.combine_chunks().to_batches(max_chunksize=64_000)
    tasks = [ReadTask((lambda b=b: pa.Table.from_batches([b])),
                      {"num_rows": b.num_rows}) for b in batches]
    if not tasks:
        tasks = [ReadTask(lambda: table.schema.empty_table())]
    return _dataset(InputData(read_tasks=tasks), "from_huggingface")
