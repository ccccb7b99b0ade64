"""Preprocessors — fit/transform over Datasets (the port of
``ray_tpu/data/preprocessors.py``).

Reference: python/ray/data/preprocessors/ (Preprocessor base with
fit/transform/fit_transform; StandardScaler, MinMaxScaler,
LabelEncoder, OneHotEncoder, Concatenator, Chain). Fitting runs as a
streaming aggregation over blocks; transform is a regular map_batches,
so it fuses into the plan like any other stage.
"""

from __future__ import annotations

import numpy as np


class Preprocessor:
    """fit(ds) computes state; transform(ds) applies it lazily."""

    _fitted = False

    def fit(self, ds) -> "Preprocessor":
        self._fit(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        if not self._fitted:
            raise RuntimeError(
                f"{type(self).__name__}.transform before fit()")
        return ds.map_batches(self._transform_numpy)

    def fit_transform(self, ds):
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: dict) -> dict:
        if not self._fitted:
            raise RuntimeError(
                f"{type(self).__name__}.transform_batch before fit()")
        return self._transform_numpy(dict(batch))

    # -- to override --------------------------------------------------
    def _fit(self, ds) -> None:
        raise NotImplementedError

    def _transform_numpy(self, batch: dict) -> dict:
        raise NotImplementedError


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference:
    preprocessors/scaler.py StandardScaler)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict[str, tuple[float, float]] = {}

    def _fit(self, ds) -> None:
        # One streaming pass: per-column count/sum/sumsq.
        agg = {c: [0, 0.0, 0.0] for c in self.columns}
        for batch in ds.iter_batches(batch_size=None,
                                     batch_format="numpy"):
            for c in self.columns:
                v = np.asarray(batch[c], dtype=np.float64)
                agg[c][0] += v.size
                agg[c][1] += float(v.sum())
                agg[c][2] += float((v * v).sum())
        for c, (n, s, ss) in agg.items():
            mean = s / max(n, 1)
            var = max(ss / max(n, 1) - mean * mean, 0.0)
            self.stats_[c] = (mean, float(np.sqrt(var)))

    def _transform_numpy(self, batch: dict) -> dict:
        for c in self.columns:
            mean, std = self.stats_[c]
            batch[c] = ((np.asarray(batch[c], dtype=np.float64) - mean)
                        / (std or 1.0))
        return batch


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column (reference: MinMaxScaler)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.stats_: dict[str, tuple[float, float]] = {}

    def _fit(self, ds) -> None:
        agg = {c: [np.inf, -np.inf] for c in self.columns}
        for batch in ds.iter_batches(batch_size=None,
                                     batch_format="numpy"):
            for c in self.columns:
                v = np.asarray(batch[c], dtype=np.float64)
                agg[c][0] = min(agg[c][0], float(v.min()))
                agg[c][1] = max(agg[c][1], float(v.max()))
        self.stats_ = {c: (lo, hi) for c, (lo, hi) in agg.items()}

    def _transform_numpy(self, batch: dict) -> dict:
        for c in self.columns:
            lo, hi = self.stats_[c]
            span = (hi - lo) or 1.0
            batch[c] = (np.asarray(batch[c], dtype=np.float64) - lo) / span
        return batch


class LabelEncoder(Preprocessor):
    """Categorical values -> dense int codes (reference: LabelEncoder)."""

    def __init__(self, label_column: str):
        self.label_column = label_column
        self.classes_: list = []

    def _fit(self, ds) -> None:
        values: set = set()
        for batch in ds.iter_batches(batch_size=None,
                                     batch_format="numpy"):
            values.update(np.asarray(batch[self.label_column]).tolist())
        self.classes_ = sorted(values)
        self._index = {v: i for i, v in enumerate(self.classes_)}

    def _transform_numpy(self, batch: dict) -> dict:
        col = np.asarray(batch[self.label_column])
        batch[self.label_column] = np.asarray(
            [self._index[v] for v in col.tolist()], dtype=np.int64)
        return batch


class OneHotEncoder(Preprocessor):
    """Categorical column -> one-hot float matrix column (reference:
    OneHotEncoder; emits a single fixed-width array column like the
    reference's encoded output)."""

    def __init__(self, columns: list[str]):
        self.columns = list(columns)
        self.classes_: dict[str, list] = {}

    def _fit(self, ds) -> None:
        values: dict[str, set] = {c: set() for c in self.columns}
        for batch in ds.iter_batches(batch_size=None,
                                     batch_format="numpy"):
            for c in self.columns:
                values[c].update(np.asarray(batch[c]).tolist())
        self.classes_ = {c: sorted(v) for c, v in values.items()}
        self._index = {c: {v: i for i, v in enumerate(vals)}
                       for c, vals in self.classes_.items()}

    def _transform_numpy(self, batch: dict) -> dict:
        for c in self.columns:
            col = np.asarray(batch[c])
            idx = self._index[c]
            out = np.zeros((len(col), len(idx)), dtype=np.float32)
            for row, v in enumerate(col.tolist()):
                out[row, idx[v]] = 1.0
            batch[c] = out
        return batch


class Concatenator(Preprocessor):
    """Merge numeric columns into one vector column (reference:
    preprocessors/concatenator.py)."""

    _fitted = True  # stateless

    def __init__(self, columns: list[str], output_column_name: str = "concat_out"):
        self.columns = list(columns)
        self.output_column_name = output_column_name

    def _fit(self, ds) -> None:
        pass

    def _transform_numpy(self, batch: dict) -> dict:
        parts = []
        for c in self.columns:
            v = np.asarray(batch.pop(c), dtype=np.float64)
            parts.append(v[:, None] if v.ndim == 1 else v)
        batch[self.output_column_name] = np.concatenate(parts, axis=1)
        return batch


class Chain(Preprocessor):
    """Apply preprocessors in sequence (reference: chain.py)."""

    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def fit(self, ds) -> "Chain":
        # Each stage fits on the PREVIOUS stages' transformed output.
        for i, p in enumerate(self.preprocessors):
            p.fit(ds)
            ds = p.transform(ds)
        self._fitted = True
        return self

    def transform(self, ds):
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def _transform_numpy(self, batch: dict) -> dict:
        for p in self.preprocessors:
            batch = p._transform_numpy(batch)
        return batch


__all__ = [
    "Chain",
    "Concatenator",
    "LabelEncoder",
    "MinMaxScaler",
    "OneHotEncoder",
    "Preprocessor",
    "StandardScaler",
]
