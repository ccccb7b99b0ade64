"""ray_tpu_torch.data — lazy, streaming datasets over the task runtime.

The port of ``ray_tpu/data/``: the same public names, blocks that are
``pyarrow.Table``s, and the same plan, optimizer, executor and readers.
Where the reference feeds the TPU with ``iter_jax_batches``, the port
has ``iter_device_batches`` (``iterator.py``, ``_device_feed.py``): dicts
of tensors already on the card, staged one batch ahead.

pyarrow (and, for some readers, pandas) is imported by this package
only, and only when one of its names is first used: ``import
ray_tpu_torch`` and its other packages do not need it, and the device
feed (``_device_feed``, numpy and torch only) imports without it.
"""

import importlib

_EXPORTS = {
    "Block": "block",
    "BlockAccessor": "block",
    "Dataset": "dataset",
    "GroupedData": "grouped",
    **{name: "read_api" for name in (
        "from_arrow", "from_huggingface", "from_items", "from_numpy",
        "from_pandas", "from_torch", "range", "read_binary_files",
        "read_csv", "read_images", "read_json", "read_numpy",
        "read_parquet", "read_sql", "read_text")},
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__() -> list:
    return sorted(set(globals()) | set(_EXPORTS))
