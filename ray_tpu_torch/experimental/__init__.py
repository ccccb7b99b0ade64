"""Experimental APIs: the internal KV (the port of ``ray_tpu/experimental``;
its compiled-graph channels are not ported)."""

from ray_tpu_torch.experimental.internal_kv import (
    internal_kv_del,
    internal_kv_exists,
    internal_kv_get,
    internal_kv_list,
    internal_kv_put,
)

__all__ = [
    "internal_kv_del",
    "internal_kv_exists",
    "internal_kv_get",
    "internal_kv_list",
    "internal_kv_put",
]
