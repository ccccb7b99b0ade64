"""The port's data package against the JAX package's.

Each mirrored case is a scenario of tests/test_data.py (all 43 of its
cases) or of the two preprocessor cases of tests/test_parity_misc.py.
It runs once through ``ray_tpu`` and once through ``ray_tpu_torch``, each
under its own ``init(num_cpus=8)`` and ``shutdown()``, and returns a
plain record (values, row lists, schema field names and types as
strings, exception class names); the two records must be equal, and
hold what the mirrored test asserts. The functions that cross into
block tasks are defined inside the scenarios.

Where the port deliberately differs from the reference:

- the device feed is ``iter_device_batches`` (dicts of tensors on the
  card, or plain CPU tensors with ``device="cpu"``) where the reference
  has ``iter_jax_batches`` (``jax.Array``s); ``iter_torch_batches`` keeps
  the reference's meaning (host tensors);
- the feed takes ``mesh=`` (a ``DeviceMesh``; batches placed as
  ``shard_batch`` places them) where the reference takes ``sharding=``;
- without a card and without ``device="cpu"`` the feed raises.
"""

import importlib
import os
import textwrap
import threading
import time

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch
import torch.distributed as dist

import ray_tpu
import ray_tpu.data  # noqa: F401 — the package each scenario reaches
import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401

PACKAGES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}
JOIN_TIMEOUT_S = 60.0


def _run(scenario, name, *args, **init):
    rt = PACKAGES[name]
    data = importlib.import_module(f"{name}.data")
    rt.shutdown()
    rt.init(num_cpus=8, **init)
    try:
        return scenario(rt, data, *args)
    finally:
        rt.shutdown()


def _both(scenario, *args, **init):
    """The scenario's record through both packages; they must agree."""
    records = {name: _run(scenario, name, *args, **init)
               for name in PACKAGES}
    assert records["ray_tpu_torch"] == records["ray_tpu"], records
    return records["ray_tpu_torch"]


def _plain(x):
    """A record of a value: arrays and tensors as (dtype, shape, values)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray):
        return ["ndarray", str(x.dtype), list(x.shape), x.tolist()]
    if isinstance(x, np.generic):
        return [type(x).__name__, x.item()]
    return x


def _schema(schema) -> list:
    return [(f.name, str(f.type)) for f in schema]


def _module(data, name: str):
    return importlib.import_module(f"{data.__name__}.{name}")


# ------------------------------------------------ mirrored: test_data


def test_range_count_take():
    def scenario(rt, data):
        ds = data.range(100, override_num_blocks=4)
        return [ds.count(), ds.take(3), ds.num_blocks(),
                _schema(ds.schema())]

    assert _both(scenario) == [100, [{"id": 0}, {"id": 1}, {"id": 2}], 4,
                               [("id", "int64")]]


def test_from_items_and_schema():
    def scenario(rt, data):
        ds = data.from_items([{"x": i, "y": str(i)} for i in range(10)])
        return [ds.count(), sorted(ds.columns()), _schema(ds.schema())]

    assert _both(scenario) == [10, ["x", "y"],
                               [("x", "int64"), ("y", "string")]]


def test_map_and_filter():
    def scenario(rt, data):
        ds = data.range(20).map(lambda row: {"id": row["id"] * 2})
        even = data.range(20).filter(lambda row: row["id"] % 2 == 0)
        return [ds.take(3), even.count(), even.take_all()]

    record = _both(scenario)
    assert record[:2] == [[{"id": 0}, {"id": 2}, {"id": 4}], 10]
    assert record[2] == [{"id": i} for i in range(0, 20, 2)]


def test_map_batches_numpy():
    def scenario(rt, data):
        ds = data.range(100, override_num_blocks=5).map_batches(
            lambda b: {"id": b["id"] + 1})
        return [ds.take(2), ds.count()]

    assert _both(scenario) == [[{"id": 1}, {"id": 2}], 100]


def test_flat_map():
    def scenario(rt, data):
        ds = data.from_items([{"n": 2}, {"n": 3}]).flat_map(
            lambda row: [{"v": row["n"]}] * row["n"])
        return [ds.count(), ds.take_all()]

    assert _both(scenario) == [5, [{"v": 2}] * 2 + [{"v": 3}] * 3]


def test_limit_streams_early():
    def scenario(rt, data):
        return data.range(1000, override_num_blocks=50).limit(5).take_all()

    assert _both(scenario) == [{"id": i} for i in range(5)]


def test_repartition():
    def scenario(rt, data):
        ds = data.range(100, override_num_blocks=10).repartition(3)
        return [ds.num_blocks(), ds.count()]

    assert _both(scenario) == [3, 100]


def test_random_shuffle_preserves_rows():
    def scenario(rt, data):
        ds = data.range(50, override_num_blocks=5).random_shuffle(seed=7)
        return [r["id"] for r in ds.take_all()]

    # The same seed draws the same permutation in both packages.
    assert sorted(_both(scenario)) == list(range(50))


def test_sort():
    def scenario(rt, data):
        vals = np.random.default_rng(0).permutation(60)
        asc = data.from_items([{"v": int(v)} for v in vals]).sort("v")
        desc = data.from_items([{"v": int(v)} for v in vals]).sort(
            "v", descending=True)
        return [[r["v"] for r in asc.take_all()],
                [r["v"] for r in desc.take_all()]]

    asc, desc = _both(scenario)
    assert asc == sorted(asc) == list(range(60))
    assert desc == sorted(desc, reverse=True)


def test_groupby_aggregates():
    def scenario(rt, data):
        ds = data.from_items([{"k": i % 3, "v": i} for i in range(12)])
        sums = {r["k"]: r["sum(v)"]
                for r in ds.groupby("k").sum("v").take_all()}
        counts = {r["k"]: r["count()"]
                  for r in ds.groupby("k").count().take_all()}
        return [sums, counts]

    sums, counts = _both(scenario)
    assert sums == {0: 0 + 3 + 6 + 9, 1: 1 + 4 + 7 + 10, 2: 2 + 5 + 8 + 11}
    assert counts == {0: 4, 1: 4, 2: 4}


def test_groupby_map_groups():
    def scenario(rt, data):
        ds = data.from_items([{"k": i % 2, "v": float(i)} for i in range(10)])
        normed = ds.groupby("k").map_groups(
            lambda g: {"k": g["k"], "v": g["v"] - g["v"].mean()})
        return sorted((r["k"], r["v"]) for r in normed.take_all())

    record = _both(scenario)
    assert len(record) == 10 and all(abs(v) < 10 for _, v in record)


def test_iter_batches_batch_size():
    def scenario(rt, data):
        ds = data.range(103, override_num_blocks=7)
        return [[len(b["id"]) for b in ds.iter_batches(batch_size=25)],
                [len(b["id"]) for b in ds.iter_batches(batch_size=25,
                                                       drop_last=True)]]

    sizes, dropped = _both(scenario)
    assert sum(sizes) == 103 and all(s == 25 for s in sizes[:-1])
    assert dropped == [25] * 4


def test_iter_batches_formats():
    def scenario(rt, data):
        ds = data.range(10)
        pandas_batch = next(iter(ds.iter_batches(batch_size=4,
                                                 batch_format="pandas")))
        arrow_batch = next(iter(ds.iter_batches(batch_size=4,
                                                batch_format="pyarrow")))
        return [list(pandas_batch["id"]), isinstance(arrow_batch, pa.Table),
                arrow_batch.to_pylist()]

    record = _both(scenario)
    assert record[:2] == [[0, 1, 2, 3], True]


def test_iter_jax_batches_device():
    """``iter_jax_batches`` in the reference, ``iter_device_batches`` on
    the CPU in the port: the same values, as ``np.asarray`` of each."""

    def scenario(rt, data):
        ds = data.range(64).map_batches(
            lambda b: {"x": b["id"].astype(np.float32)})
        if rt is ray_tpu:
            batches = list(ds.iter_jax_batches(batch_size=16))
            kind = isinstance(batches[0]["x"], jax.Array)
        else:
            batches = list(ds.iter_device_batches(batch_size=16,
                                                  device="cpu"))
            kind = isinstance(batches[0]["x"], torch.Tensor) \
                and batches[0]["x"].device.type == "cpu"
        return [len(batches), kind, float(batches[0]["x"].sum()),
                [_plain(np.asarray(b["x"])) for b in batches]]

    record = _both(scenario)
    assert record[:3] == [4, True, sum(range(16))]


def test_split_and_shard():
    def scenario(rt, data):
        ds = data.range(100, override_num_blocks=10)
        shards = ds.split(4)
        return [[s.count() for s in shards], ds.shard(4, 0).count(),
                [r["id"] for r in ds.shard(4, 1).take_all()]]

    counts, shard0, _ = _both(scenario)
    assert sum(counts) == 100 and shard0 == counts[0]


def test_union_zip():
    def scenario(rt, data):
        a = data.range(5)
        z = a.zip(data.range(5).map(lambda r: {"other": r["id"] * 10}))
        return [a.union(data.range(5)).count(), z.take_all()]

    count, rows = _both(scenario)
    assert count == 10 and rows[2] == {"id": 2, "other": 20}


def test_aggregates():
    def scenario(rt, data):
        ds = data.range(10)
        return [ds.sum("id"), ds.min("id"), ds.max("id"), ds.mean("id"),
                ds.unique("id"), ds.std("id")]

    record = _both(scenario)
    assert record[:5] == [45, 0, 9, 4.5, list(range(10))]


def test_read_write_parquet_roundtrip(tmp_path):
    def scenario(rt, data, tmp):
        out = str(tmp / rt.__name__)
        data.range(30, override_num_blocks=3).write_parquet(out)
        back = data.read_parquet(out)
        return [back.count(), sorted(r["id"] for r in back.take_all()),
                sorted(os.listdir(out))]

    count, ids, files = _both(scenario, tmp_path)
    assert count == 30 and ids == list(range(30)) and len(files) == 3


def test_read_write_csv_json(tmp_path):
    def scenario(rt, data, tmp):
        root = tmp / rt.__name__
        ds = data.from_items([{"a": i, "b": float(i)} for i in range(5)])
        ds.write_csv(str(root / "csv"))
        ds.write_json(str(root / "json"))
        return [data.read_csv(str(root / "csv")).count(),
                data.read_json(str(root / "json")).count(),
                data.read_json(str(root / "json")).take_all()]

    record = _both(scenario, tmp_path)
    assert record[:2] == [5, 5]


def test_tensor_columns_roundtrip():
    def scenario(rt, data):
        arr = np.arange(24, dtype=np.float32).reshape(6, 4)
        batch = data.from_numpy({"x": arr}).take_batch(6)
        return [_plain(batch["x"]), bool(np.array_equal(batch["x"], arr))]

    assert _both(scenario)[1] is True


def test_ndim_tensor_columns_keep_shape():
    def scenario(rt, data):
        arr = np.arange(4 * 3 * 5, dtype=np.float32).reshape(4, 3, 5)
        ds = data.from_numpy({"img": arr})
        batch = ds.take_batch(4)
        return [list(batch["img"].shape),
                bool(np.array_equal(batch["img"], arr)),
                _schema(ds.schema())]

    shape, equal, _ = _both(scenario)
    assert shape == [4, 3, 5] and equal


def test_heterogeneous_row_keys_union():
    def scenario(rt, data):
        ds = data.from_items([{"a": 1}]).flat_map(
            lambda r: [{"a": 1}, {"a": 2, "b": 3}])
        return ds.take_all()

    rows = _both(scenario)
    assert rows[1]["b"] == 3 and rows[0].get("b") is None


def test_unseeded_shuffle_differs_across_runs():
    def scenario(rt, data):
        ds = data.range(100, override_num_blocks=2)
        a = [r["id"] for r in ds.random_shuffle().take_all()]
        b = [r["id"] for r in ds.random_shuffle().take_all()]
        s1 = [r["id"] for r in ds.random_shuffle(seed=3).take_all()]
        s2 = [r["id"] for r in ds.random_shuffle(seed=3).take_all()]
        return [a != b, s1 == s2, s1]

    differ, same, _ = _both(scenario)
    assert differ and same


def test_select_drop_rename():
    def scenario(rt, data):
        ds = data.from_items([{"a": 1, "b": 2, "c": 3}])
        return [ds.select_columns(["a"]).columns(),
                sorted(ds.drop_columns(["a"]).columns()),
                ds.rename_columns({"a": "z"}).columns()]

    select, drop, rename = _both(scenario)
    assert select == ["a"] and drop == ["b", "c"] and "z" in rename


def test_streaming_executor_is_lazy():
    def scenario(rt, data):
        calls = {"n": 0}

        def spy(batch):
            calls["n"] += 1
            return batch

        ds = data.range(1000, override_num_blocks=100).map_batches(spy)
        before = calls["n"]
        ds.take(1)
        return [before, calls["n"] < 100]

    assert _both(scenario) == [0, True]


def test_train_integration_datasets():
    """Through each package's ``DataParallelTrainer``: each of 2 workers
    iterates its shard."""

    def scenario(rt, data):
        train = importlib.import_module(f"{rt.__name__}.train")
        ds = data.range(64).map_batches(
            lambda b: {"x": b["id"].astype(np.float32)})

        def loop(config):
            total, n = 0.0, 0
            for batch in config["datasets"]["train"].iter_batches(
                    batch_size=8):
                total += float(batch["x"].sum())
                n += len(batch["x"])
            train.report({"total": total, "rows": n})

        result = train.DataParallelTrainer(
            loop, scaling_config=train.ScalingConfig(num_workers=2),
            datasets={"train": ds}).fit()
        return [result.error is None, result.metrics["rows"]]

    assert _both(scenario) == [True, 32]


# -------------------------------------------- streaming_split / stats


def test_streaming_split_covers_all_rows():
    def scenario(rt, data):
        ds = data.range(1000, override_num_blocks=10).map(
            lambda row: {"id": row["id"], "sq": row["id"] ** 2})
        iterators = ds.streaming_split(3)
        seen = [[] for _ in range(3)]

        def consume(i):
            for batch in iterators[i].iter_batches(batch_size=64):
                seen[i].extend(int(x) for x in batch["id"])

        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_TIMEOUT_S)
        return [len(iterators), any(t.is_alive() for t in threads),
                sorted(x for part in seen for x in part),
                all(part for part in seen)]

    n, hung, ids, nonempty = _both(scenario)
    assert n == 3 and not hung and ids == list(range(1000)) and nonempty


def test_streaming_split_equal_balances_rows():
    def scenario(rt, data):
        ds = data.from_items([{"v": i} for i in range(100)]).repartition(5)
        counts = [sum(1 for _ in it.iter_rows())
                  for it in ds.streaming_split(2, equal=True)]
        return [sum(counts), abs(counts[0] - counts[1]) <= 40]

    assert _both(scenario) == [100, True]


def test_dataset_stats_reports_stages():
    def scenario(rt, data):
        ds = data.range(100, override_num_blocks=4).map(
            lambda r: {"x": r["id"]})
        before = "(not executed yet)" in ds.stats()
        ds.take_all()
        report = ds.stats()
        return [before, "Execution stats:" in report,
                "blocks" in report and "wall" in report,
                report.splitlines()[0]]

    assert _both(scenario)[:3] == [True, True, True]


def test_repartition_balances_many_small_blocks():
    def scenario(rt, data):
        ds = data.from_items([{"v": i} for i in range(100)]).repartition(5)
        rows_per_block = [rt.get(r).num_rows for r in ds._block_refs()]
        return [rows_per_block, sorted(r["v"] for r in ds.take_all())]

    rows_per_block, values = _both(scenario)
    assert sum(rows_per_block) == 100
    assert max(rows_per_block) <= 40 and min(rows_per_block) >= 5
    assert values == list(range(100))


def test_streaming_split_survives_abandoned_consumer():
    def scenario(rt, data):
        ds = data.range(600, override_num_blocks=12).map(
            lambda r: {"id": r["id"]})
        its = ds.streaming_split(2, max_queued_blocks=1)
        first = []
        for batch in its[0].iter_batches(batch_size=10):
            first.extend(int(x) for x in batch["id"])
            break  # abandon
        rest = []

        def consume():
            for batch in its[1].iter_batches(batch_size=50):
                rest.extend(int(x) for x in batch["id"])

        t = threading.Thread(target=consume)
        t.start()
        t.join(timeout=30)
        return [len(first), t.is_alive(), len(rest) >= 400]

    assert _both(scenario) == [10, False, True]


def test_streaming_split_propagates_upstream_error():
    def scenario(rt, data):
        def poison(row):
            if row["id"] == 37:
                raise RuntimeError("poisoned row")
            return row

        ds = data.range(100, override_num_blocks=10).map(poison)
        seen = []
        for equal in (True, False):
            errors = []

            def run(it):
                try:
                    for _ in it.iter_batches(batch_size=10):
                        pass
                except Exception as exc:  # noqa: BLE001 — recorded
                    errors.append(type(exc).__name__)

            threads = [threading.Thread(target=run, args=(it,))
                       for it in ds.streaming_split(2, equal=equal)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            seen.append([bool(errors), sorted(set(errors))])
        return seen

    record = _both(scenario)
    assert [saw for saw, _ in record] == [True, True]


# ------------------------------------------------ backpressure policies


def test_per_op_cap_bounds_read_ahead_under_slow_consumer(tmp_path):
    def scenario(rt, data, tmp):
        progress = str(tmp / f"{rt.__name__}.progress")

        def tracked(row):
            with open(progress, "a") as f:
                f.write("x\n")
            return row

        ds = (data.from_items([{"i": i} for i in range(24)])
              .repartition(24)
              .map(tracked)
              .execution_options(per_op_caps={"Map": 2}, max_in_flight=2))
        consumed = max_ahead = 0
        for ref in ds._block_ref_iter():
            rt.get(ref)
            consumed += 1
            time.sleep(0.05)  # slow consumer
            try:
                with open(progress) as f:
                    produced = sum(1 for _ in f)
            except FileNotFoundError:
                produced = 0
            max_ahead = max(max_ahead, produced - consumed)
        return [consumed, max_ahead <= 6]

    assert _both(scenario, tmp_path) == [24, True]


def test_backpressure_policy_plugin():
    def scenario(rt, data):
        base = _module(data, "backpressure").BackpressurePolicy

        class OneAtATime(base):
            def __init__(self):
                self.consulted = 0

            def can_add_input(self, op_name, in_flight):
                self.consulted += 1
                return in_flight < 1

        policy = OneAtATime()
        ds = (data.from_items([{"i": i} for i in range(8)])
              .repartition(8)
              .map(lambda r: {"i": r["i"] * 2})
              .execution_options(policies=[policy]))
        return [sorted(r["i"] for r in ds.take_all()), policy.consulted > 0]

    assert _both(scenario) == [[i * 2 for i in range(8)], True]


# --------------------------------------------------- logical optimizer


def test_optimizer_limit_pushes_through_row_preserving_ops():
    def scenario(rt, data):
        plan = _module(data, "plan")
        ops = [plan.InputData(block_refs=[]),
               plan.MapBlocks(lambda b: b, name="Map", row_preserving=True),
               plan.MapBlocks(lambda b: b, name="Rename",
                              row_preserving=True),
               plan.Limit(limit=5)]
        out, applied = _module(data, "optimizer").optimize(ops)
        return [applied, isinstance(out[1], plan.Limit) and out[1].limit,
                [op.name for op in out]]

    applied, limit, names = _both(scenario)
    assert "LimitPushdown" in applied and "OperatorFusion" in applied
    assert limit == 5 and names == ["Input", "Limit", "Map->Rename"]


def test_optimizer_limit_stops_at_non_preserving_ops():
    def scenario(rt, data):
        plan = _module(data, "plan")
        ops = [plan.InputData(block_refs=[]),
               plan.MapBlocks(lambda b: b, name="Filter",
                              row_preserving=False),
               plan.Limit(limit=5)]
        out, _ = _module(data, "optimizer").optimize(ops)
        return [isinstance(out[-1], plan.Limit), out[1].name]

    assert _both(scenario) == [True, "Filter"]


def test_optimizer_collapses_adjacent_limits_and_projects():
    def scenario(rt, data):
        plan = _module(data, "plan")
        ops = [plan.InputData(block_refs=[]),
               plan.MapBlocks(lambda b: b.select(["a", "b"]),
                              name="SelectColumns", row_preserving=True,
                              kind="project", cols=["a", "b"]),
               plan.MapBlocks(lambda b: b.select(["a"]),
                              name="SelectColumns", row_preserving=True,
                              kind="project", cols=["a"]),
               plan.Limit(limit=10), plan.Limit(limit=3)]
        out, applied = _module(data, "optimizer").optimize(ops)
        return [applied,
                [op.limit for op in out if isinstance(op, plan.Limit)],
                [op.cols for op in out if isinstance(op, plan.MapBlocks)
                 and op.kind == "project"]]

    applied, limits, projects = _both(scenario)
    assert "ProjectionMerge" in applied
    assert limits == [3] and projects == [["a"]]


def test_optimized_pipeline_results_unchanged():
    def scenario(rt, data):
        ds = (data.range(100)
              .map(lambda r: {"id": r["id"], "sq": r["id"] ** 2})
              .rename_columns({"sq": "square"})
              .limit(7))
        rows = ds.take_all()
        stats = ds.stats()
        return [[r["square"] for r in rows], "optimizer:" in stats,
                "LimitPushdown" in stats]

    assert _both(scenario) == [[i ** 2 for i in range(7)], True, True]


# ------------------------------------------------------ connectors


def test_read_sql_sharded_and_plain(tmp_path):
    import sqlite3

    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE pets (name TEXT, kind TEXT, age INT)")
    conn.executemany(
        "INSERT INTO pets VALUES (?, ?, ?)",
        [("rex", "dog", 3), ("tom", "cat", 2), ("ada", "dog", 5),
         ("kit", "cat", 1)])
    conn.commit()
    conn.close()

    def scenario(rt, data):
        ds = data.read_sql("SELECT name, age FROM pets",
                           lambda: __import__("sqlite3").connect(db))
        names = [r["name"] for r in sorted(ds.take_all(),
                                           key=lambda r: r["name"])]
        sharded = data.read_sql(
            "SELECT name, kind, age FROM pets WHERE age > 0",
            lambda: __import__("sqlite3").connect(db),
            shard_keys=["dog", "cat"], shard_column="kind")
        return [names, sharded.num_blocks(), sharded.count(),
                _schema(sharded.schema())]

    record = _both(scenario)
    assert record[:3] == [["ada", "kit", "rex", "tom"], 2, 4]


def test_read_images_resize_and_paths(tmp_path):
    from PIL import Image

    for i, color in enumerate([(255, 0, 0), (0, 255, 0)]):
        Image.new("RGB", (8, 6), color).save(tmp_path / f"img{i}.png")

    def scenario(rt, data):
        ds = data.read_images(str(tmp_path), size=(3, 4), mode="RGB",
                              include_paths=True)
        rows = sorted(ds.take_all(), key=lambda r: r["path"])
        return [len(rows), [_plain(np.asarray(r["image"])) for r in rows]]

    n, images = _both(scenario)
    assert n == 2
    assert images[0][2] == [3, 4, 3] and images[0][3][0][0][0] == 255


def test_from_torch_dataset():
    import torch.utils.data as tud

    class Squares(tud.Dataset):
        def __len__(self):
            return 5

        def __getitem__(self, i):
            return {"x": i, "sq": i * i}

    def scenario(rt, data):
        return [r["sq"] for r in data.from_torch(Squares()).take_all()]

    assert _both(scenario) == [0, 1, 4, 9, 16]


def test_from_huggingface_roundtrip():
    hf = pytest.importorskip("datasets")

    def scenario(rt, data):
        hfds = hf.Dataset.from_dict({"a": list(range(10)),
                                     "b": [str(i) for i in range(10)]})
        ds = data.from_huggingface(hfds)
        return [ds.count(), sorted(r["a"] for r in ds.take_all()),
                _schema(ds.schema())]

    count, values, _ = _both(scenario)
    assert count == 10 and values == list(range(10))


def test_write_numpy_roundtrip(tmp_path):
    import glob

    def scenario(rt, data, tmp):
        out = str(tmp / rt.__name__)
        data.range(20).map(lambda r: {"v": float(r["id"])}).write_numpy(
            out, column="v")
        parts = sorted(glob.glob(out + "/part-*.npy"))
        vals = np.concatenate([np.load(p) for p in parts])
        try:
            data.range(3).write_numpy(out, column="missing")
            missing = None
        except KeyError as exc:
            missing = type(exc).__name__
        return [sorted(vals.tolist()), missing]

    assert _both(scenario, tmp_path) == [[float(i) for i in range(20)],
                                         "KeyError"]


# --------------------------------- mirrored: test_parity_misc (data)


def test_standard_and_minmax_scalers():
    def scenario(rt, data):
        pre = _module(data, "preprocessors")
        ds = data.from_items(
            [{"a": float(i), "b": float(2 * i)} for i in range(100)])
        scaler = pre.StandardScaler(["a", "b"]).fit(ds)
        scaled = np.array([r["a"] for r in scaler.transform(ds).take_all()])
        mm = pre.MinMaxScaler(["a"]).fit(ds)
        ranged = np.array([r["a"] for r in mm.transform(ds).take_all()])
        return [scaler.stats_, scaled.tolist(), mm.stats_, ranged.tolist()]

    stats, scaled, _, ranged = _both(scenario)
    scaled = np.array(scaled)
    assert abs(scaled.mean()) < 1e-6 and abs(scaled.std() - 1.0) < 1e-6
    assert min(ranged) == 0.0 and max(ranged) == 1.0
    assert set(stats) == {"a", "b"}


def test_label_onehot_concat_chain():
    def scenario(rt, data):
        pre = _module(data, "preprocessors")
        ds = data.from_items([
            {"color": c, "x": float(i)}
            for i, c in enumerate(["red", "green", "blue", "green"] * 5)])
        le = pre.LabelEncoder("color").fit(ds)
        labels = le.transform(ds).take_all()
        oh = pre.OneHotEncoder(["color"]).fit(ds)
        onehot = oh.transform(ds).take_all()
        chain = pre.Chain(pre.OneHotEncoder(["color"]),
                          pre.Concatenator(["color", "x"], "features")
                          ).fit(ds)
        features = chain.transform(ds).take_all()
        return [le.classes_,
                all(isinstance(r["color"], (int, np.integer))
                    for r in labels),
                [r["color"] for r in labels],
                _plain(np.asarray(onehot[0]["color"])),
                _plain([np.asarray(r["features"]) for r in features])]

    classes, ints, _, first, features = _both(scenario)
    assert classes == ["blue", "green", "red"] and ints
    assert first[2] == [3] and sum(first[3]) == 1.0
    assert features[0][2] == [4]


# --------------------------------------------------- port only


def test_parquet_written_by_either_package_reads_back_in_the_other(
        tmp_path):
    """A tensor column (its shape in the field metadata, under the same
    key in both packages) written by one package reads back with its
    shape and values in the other."""
    arr = np.arange(4 * 3 * 5, dtype=np.float32).reshape(4, 3, 5)

    def write(rt, data, path):
        data.from_numpy({"img": arr}).write_parquet(path)

    def read(rt, data, path):
        return _plain(data.read_parquet(path).take_batch(4)["img"])

    for writer, reader in (("ray_tpu", "ray_tpu_torch"),
                           ("ray_tpu_torch", "ray_tpu")):
        path = str(tmp_path / writer)
        _run(write, writer, path)
        assert _run(read, reader, path) == _plain(arr)


def test_iter_device_batches_casts_in_numpy_and_raises_without_a_card(
        monkeypatch):
    from ray_tpu_torch import data

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        ds = data.range(10).map_batches(
            lambda b: {"t": b["id"].astype(np.int32), "f": b["id"] / 2})
        batches = list(ds.iter_device_batches(
            batch_size=4, device="cpu", dtypes={"t": np.int64}))
        assert [b["t"].tolist() for b in batches] == [[0, 1, 2, 3],
                                                      [4, 5, 6, 7]]
        assert batches[0]["t"].dtype == torch.int64
        assert batches[0]["f"].dtype == torch.float64
        tail = list(ds.iter_device_batches(batch_size=4, drop_last=False,
                                           device="cpu"))
        assert tail[-1]["t"].tolist() == [8, 9]
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ds.iter_device_batches(batch_size=4)
        split = ds.streaming_split(1)[0]
        with pytest.raises(RuntimeError, match="device='cpu'"):
            split.iter_device_batches(batch_size=4)
        split.close()
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture
def no_process_group():
    """A case that brings up the default group destroys it after."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_iter_device_batches_on_a_mesh_places_as_shard_batch(
        no_process_group):
    """``mesh=`` gives DTensors with ``shard_batch``'s placements and its
    values, which are the reference's ``iter_jax_batches`` values."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import build_mesh
    from ray_tpu_torch.parallel.train_step import shard_batch

    tokens = np.random.default_rng(0).integers(0, 256, (16, 9)).astype(
        np.int32)

    def scenario(rt, data):
        ds = data.from_numpy({"tokens": tokens}).repartition(2)
        if rt is ray_tpu:
            return [_plain(np.asarray(b["tokens"]))
                    for b in ds.iter_jax_batches(batch_size=4)]
        mesh = build_mesh(device="cpu")
        batches = list(ds.iter_device_batches(batch_size=4, mesh=mesh))
        for i, batch in enumerate(batches):
            want = shard_batch({"tokens": tokens[4 * i:4 * i + 4]}, mesh)
            got = batch["tokens"]
            assert isinstance(got, DTensor)
            assert got.placements == want["tokens"].placements
            assert got.device_mesh == want["tokens"].device_mesh
            assert torch.equal(got.full_tensor(),
                               want["tokens"].full_tensor())
        return [_plain(b["tokens"].full_tensor().to(torch.int32))
                for b in batches]

    record = _both(scenario)
    assert len(record) == 4
    assert record[1] == _plain(tokens[4:8])


def test_mesh_trainer_feeds_its_loop_from_a_dataset(no_process_group):
    """``datasets=`` through the port's ``MeshTrainer`` at a world of one
    on gloo, its loop fed by ``iter_device_batches(mesh=...)``, against
    the reference's ``JaxTrainer`` fed by ``iter_jax_batches``."""

    def scenario(rt, data):
        train = importlib.import_module(f"{rt.__name__}.train")
        ds = data.range(64).map_batches(
            lambda b: {"x": b["id"].astype(np.float32).reshape(-1, 1)
                       * np.ones((1, 4), np.float32)})

        def loop(config):
            shard = config["datasets"]["train"]
            total, rows, kinds = 0.0, 0, set()
            if rt is ray_tpu:
                batches = shard.iter_jax_batches(batch_size=8)
            else:
                batches = shard.iter_device_batches(
                    batch_size=8, mesh=train.get_mesh(device="cpu"))
            for batch in batches:
                x = batch["x"]
                if rt is ray_tpu_torch:
                    kinds.add(type(x).__name__)
                    x = x.full_tensor()
                total += float(np.asarray(x).sum())
                rows += int(x.shape[0])
            train.report({"total": total, "rows": rows,
                          "kinds": sorted(kinds)})

        trainer = train.JaxTrainer if rt is ray_tpu else train.MeshTrainer
        result = trainer(loop, scaling_config=train.ScalingConfig(
            num_workers=1), datasets={"train": ds}).fit()
        assert result.error is None, result.error
        return [result.metrics["total"], result.metrics["rows"]]

    assert _both(scenario) == [4.0 * sum(range(64)), 64]


_MAIN_SCALE = textwrap.dedent("""
    import dataclasses, os

    @dataclasses.dataclass
    class Scale:
        factor: int
        offset: int = 1

    def make(scale):
        def scaled(batch):
            return {"id": batch["id"] * scale.factor + scale.offset,
                    "pid": [os.getpid()] * len(batch["id"])}
        return scaled
""")


def test_pool_pipeline_runs_a_main_closure_over_a_dataclass():
    """With ``process_workers=2``, a ``map_batches`` function of
    ``__main__``'s, closing over a ``__main__`` dataclass, runs in the
    pool processes through both packages."""

    def scenario(rt, data):
        namespace = {"__name__": "__main__"}
        exec(_MAIN_SCALE, namespace)
        fn = namespace["make"](namespace["Scale"](factor=3))
        rows = data.range(40, override_num_blocks=4).map_batches(
            fn).take_all()
        pids = {r["pid"] for r in rows}
        return [[r["id"] for r in rows], os.getpid() not in pids]

    ids, in_pool = _both(scenario, process_workers=2)
    assert ids == [3 * i + 1 for i in range(40)] and in_pool
