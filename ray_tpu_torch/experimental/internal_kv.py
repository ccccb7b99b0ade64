"""Library access to the control plane's key-value store.

The port of ``ray_tpu/experimental/internal_kv.py``. Connected to a head
(``init(address=...)``), every call goes to the cluster's KV, which every
driver and job shares and the durable head persists; otherwise to this
runtime's own.
"""

from __future__ import annotations

from ray_tpu_torch._private.worker import auto_init


def _target():
    runtime = auto_init()
    if runtime.gcs_client is not None:
        return runtime.gcs_client, None
    return None, runtime.gcs.kv


def internal_kv_put(key: bytes, value: bytes,
                    namespace: str = "default") -> None:
    client, kv = _target()
    if client is not None:
        client.call("kv_put", bytes(key), bytes(value), namespace)
    else:
        kv.put(bytes(key), bytes(value), namespace)


def internal_kv_get(key: bytes, namespace: str = "default") -> bytes | None:
    client, kv = _target()
    if client is not None:
        return client.call("kv_get", bytes(key), namespace)
    return kv.get(bytes(key), namespace)


def internal_kv_del(key: bytes, namespace: str = "default") -> bool:
    client, kv = _target()
    if client is not None:
        return client.call("kv_del", bytes(key), namespace)
    return kv.delete(bytes(key), namespace)


def internal_kv_exists(key: bytes, namespace: str = "default") -> bool:
    client, kv = _target()
    if client is not None:
        return client.call("kv_exists", bytes(key), namespace)
    return kv.exists(bytes(key), namespace)


def internal_kv_list(prefix: bytes = b"",
                     namespace: str = "default") -> list[bytes]:
    client, kv = _target()
    if client is not None:
        return client.call("kv_keys", bytes(prefix), namespace)
    return kv.keys(bytes(prefix), namespace)
