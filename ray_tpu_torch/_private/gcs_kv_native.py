"""The ctypes binding of the native KV engine (``gcs_kv.cpp``).

The port of ``ray_tpu/_private/gcs_kv_native.py`` (reference: the GCS's
storage layer is C++, gcs_kv_manager.h, store_client/
in_memory_store_client.h:31). ``NativeKVStore`` has ``gcs.KVStore``'s
methods and semantics, ``version`` an attribute as there, and
``snapshot()``/``restore()`` take and give the same dict shape
(``{namespace: {key: value}}``), which the durable head pickles into its
snapshot; its WAL replays KV records through ``put``/``delete``. So a
head's state moves between the two engines either way.

Where the port differs: every key, value and buffer is checked here
before the call (bytes, under the engine's 4 GiB limit; each two-phase
read grows its buffer to the size the engine asks for, a bounded number
of times), and ``make_kv_store`` raises when the native build fails
instead of falling back: ``gcs_kv_native=False`` picks the Python store.
"""

from __future__ import annotations

import ctypes
import struct

_LIMIT = (1 << 32) - 1


def _blob(value, what: str) -> bytes:
    if not isinstance(value, (bytes, bytearray)):
        raise TypeError(f"a native KV {what} is bytes, got "
                        f"{type(value).__name__}")
    if len(value) >= _LIMIT:
        raise ValueError("key/value exceeds the native KV's 4 GiB limit")
    return bytes(value)


def _two_phase(call, start_cap: int = 4096) -> bytes | None:
    """Run a ``(buf, cap) -> needed size`` native call, growing the buffer
    until the result fits; None when the engine says absent (-1). The
    size can grow between calls (another thread wrote), so it retries."""
    cap = start_cap
    for _ in range(64):
        buf = ctypes.create_string_buffer(cap)
        need = int(call(buf, cap))
        if need < 0:
            return None
        if need <= cap:
            return buf.raw[:need]
        cap = need
    raise RuntimeError("native KV read kept growing past its buffer")


def _unpack_blobs(raw: bytes, per_entry: int) -> list[tuple[bytes, ...]]:
    """``[u32 count]`` then ``count`` entries of ``per_entry``
    u32-length-prefixed blobs, each bound checked."""
    if len(raw) < 4:
        raise ValueError("native KV image shorter than its count")
    (count,) = struct.unpack_from("<I", raw, 0)
    off, out = 4, []
    for _ in range(count):
        entry = []
        for _ in range(per_entry):
            if off + 4 > len(raw):
                raise ValueError("native KV image truncated")
            (n,) = struct.unpack_from("<I", raw, off)
            off += 4
            if off + n > len(raw):
                raise ValueError("native KV image truncated")
            entry.append(raw[off:off + n])
            off += n
        out.append(tuple(entry))
    return out


class NativeKVStore:
    """``gcs.KVStore``'s interface and semantics, C++-backed."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.gcs_kv_create()
        if not self._h:
            raise RuntimeError("native KV creation failed")

    def __del__(self):
        try:
            if self._h:
                self._lib.gcs_kv_destroy(self._h)
                self._h = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    @property
    def version(self) -> int:
        return int(self._lib.gcs_kv_version(self._h))

    def put(self, key: bytes, value: bytes, namespace: str = "default",
            overwrite: bool = True) -> bool:
        key, value = _blob(key, "key"), _blob(value, "value")
        ret = self._lib.gcs_kv_put(self._h, namespace.encode(), key, len(key),
                                   value, len(value), 1 if overwrite else 0)
        if ret < 0:
            raise ValueError("key/value exceeds the native KV's 4 GiB limit")
        return bool(ret)

    def get(self, key: bytes, namespace: str = "default") -> bytes | None:
        key = _blob(key, "key")
        ns = namespace.encode()
        return _two_phase(lambda buf, cap: self._lib.gcs_kv_get(
            self._h, ns, key, len(key), buf, cap))

    def delete(self, key: bytes, namespace: str = "default") -> bool:
        key = _blob(key, "key")
        return bool(self._lib.gcs_kv_del(self._h, namespace.encode(), key,
                                         len(key)))

    def exists(self, key: bytes, namespace: str = "default") -> bool:
        key = _blob(key, "key")
        return bool(self._lib.gcs_kv_exists(self._h, namespace.encode(), key,
                                            len(key)))

    def keys(self, prefix: bytes = b"",
             namespace: str = "default") -> list[bytes]:
        prefix = _blob(prefix, "prefix")
        ns = namespace.encode()
        raw = _two_phase(lambda buf, cap: self._lib.gcs_kv_keys(
            self._h, ns, prefix, len(prefix), buf, cap))
        return [k for (k,) in _unpack_blobs(raw, 1)] if raw else []

    # -- persistence (the Python store's dict shape) ------------------
    def snapshot(self) -> dict:
        raw = _two_phase(lambda buf, cap: self._lib.gcs_kv_snapshot(
            self._h, buf, cap), start_cap=1 << 16)
        out: dict[str, dict[bytes, bytes]] = {}
        for ns, key, value in (_unpack_blobs(raw, 3) if raw else []):
            out.setdefault(ns.decode(), {})[key] = value
        return out

    def restore(self, data: dict) -> None:
        """Merge a snapshot (existing keys are overwritten); a corrupt
        image raises ValueError and applies nothing."""
        entries = [(_blob(ns.encode(), "namespace"), _blob(k, "key"),
                    _blob(v, "value"))
                   for ns, kv in data.items() for k, v in kv.items()]
        parts = [struct.pack("<I", len(entries))]
        for entry in entries:
            for blob in entry:
                parts += [struct.pack("<I", len(blob)), blob]
        image = b"".join(parts)
        if self._lib.gcs_kv_restore(self._h, image, len(image)) < 0:
            raise ValueError("corrupt KV snapshot image")


def make_kv_store():
    """The head's KV: the native engine under ``gcs_kv_native`` (the
    default; a failed build raises), else the Python store."""
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.gcs import KVStore

    if not bool(GLOBAL_CONFIG.gcs_kv_native):
        return KVStore()
    from ray_tpu_torch._native import load

    return NativeKVStore(load())
