"""The native (C++) node object store, behind ``NodeObjectStore``'s
interface.

The port of ``ray_tpu/_private/node_store_native.py`` (reference: the
raylet's local object store is C++, src/ray/object_manager/
object_store.h). ``NativeNodeObjectStore`` keeps the daemon's blobs in
``ray_tpu_torch/_native/node_store.cpp`` with the exact interface of
``node_executor.NodeObjectStore`` (``put``/``get``/``free``/
``free_owner``/``owners``/``size``/``is_spilled``/``read_chunk``/
``notify_spill``/``stats``), so the executor treats both alike. ctypes
releases the GIL around each call, so a read never blocks the daemon's
Python threads, and a spilled blob streams back outside the store's
mutex. Past its primary cap the C++ store writes the oldest primaries to
``<pid>-<id>-native.blob`` files (no checksum, no directory events): the
managed tier needs the Python store, so ``make_node_store`` picks this
one only with ``spill_enabled`` off.

Where the port differs: ``make_node_store`` raises when the native build
fails instead of falling back (``node_store_native=False`` picks the
Python store), and every key and buffer is checked before the call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os


class NativeNodeObjectStore:
    """``NodeObjectStore``'s interface over the C++ store."""

    def __init__(self, lib, cache_limit_bytes: int | None = None,
                 primary_limit_bytes: int | None = None,
                 spill_dir: str | None = None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG

        self._lib = lib
        cache = (cache_limit_bytes if cache_limit_bytes is not None
                 else int(GLOBAL_CONFIG.node_pull_cache_mb) << 20)
        primary = (primary_limit_bytes if primary_limit_bytes is not None
                   else int(GLOBAL_CONFIG.node_store_primary_limit_mb) << 20)
        self._spill_dir = spill_dir or GLOBAL_CONFIG.node_store_spill_dir
        os.makedirs(self._spill_dir, exist_ok=True)
        purge_stale_spills(self._spill_dir)
        self._handle = lib.rt_ns_create(int(cache), int(primary),
                                        self._spill_dir.encode())
        if not self._handle:
            raise RuntimeError("native node store creation failed")

    @staticmethod
    def _key(id_bytes: bytes) -> bytes:
        if not isinstance(id_bytes, (bytes, bytearray)):
            raise TypeError(f"a node store key is bytes, got "
                            f"{type(id_bytes).__name__}")
        if len(id_bytes) == 16:
            return bytes(id_bytes)
        # Keys of another length (tests, export hashes) fold to 16 bytes.
        return hashlib.blake2b(bytes(id_bytes), digest_size=16).digest()

    def put(self, id_bytes: bytes, blob: bytes, cached: bool = False,
            owner: str | None = None, notify: bool = True) -> None:
        """``notify`` is the Python store's spiller wake-up; this store
        spills inline, so it has nothing to wake."""
        data = bytes(blob)
        self._lib.rt_ns_put(self._handle, self._key(id_bytes), data,
                            len(data), 1 if cached else 0,
                            (owner or "").encode())

    def notify_spill(self) -> None:
        """Nothing to wake: the C++ store spills inside ``put``."""

    def _read_into(self, key: bytes, offset: int, length: int):
        """(total, bytearray) in one copy (the C++ side writes straight
        into a Python-owned buffer of ``length`` bytes), or None when the
        object is absent."""
        offset, length = int(offset), int(length)
        if offset < 0 or length < 0:
            raise ValueError(f"bad read range ({offset}, {length})")
        ba = bytearray(max(1, length))
        cbuf = (ctypes.c_uint8 * len(ba)).from_buffer(ba)
        copied = ctypes.c_uint64()
        total = self._lib.rt_ns_read(self._handle, key, offset, cbuf, length,
                                     ctypes.byref(copied))
        del cbuf
        if total < 0:
            return None
        if copied.value != len(ba):
            # A short read (the tail chunk, or nothing for an empty blob).
            return int(total), ba[:copied.value]
        return int(total), ba

    def get(self, id_bytes: bytes) -> bytes | None:
        key = self._key(id_bytes)
        size = self._lib.rt_ns_size(self._handle, key)
        for _ in range(8):
            if size < 0:
                return None
            out = self._read_into(key, 0, size)
            if out is None:
                return None  # freed between the size and the read
            total, ba = out
            if total == size and len(ba) == size:
                return bytes(ba)
            if total == size:
                # A short copy at an unchanged size: the spill file came
                # back truncated. Absent, never a corrupt blob.
                return None
            # Sealed again at another size between the probe and the
            # copy: read again at the new size.
            size = total
        return None

    def free(self, ids: list[bytes]) -> int:
        if not ids:
            return 0
        packed = b"".join(self._key(i) for i in ids)
        return int(self._lib.rt_ns_free(self._handle, packed, len(ids)))

    def free_owner(self, owner: str) -> int:
        return int(self._lib.rt_ns_free_owner(self._handle, owner.encode()))

    def owners(self) -> list[str]:
        # The set may change between sizing and filling: retry with the
        # second call's own length until it fits.
        buflen = 256
        for _ in range(8):
            buf = ctypes.create_string_buffer(buflen)
            got = self._lib.rt_ns_owners(self._handle, buf, buflen)
            if got <= 0:
                return []
            if got <= buflen:
                return buf.raw[:got].decode().split("\n")
            buflen = int(got) * 2
        return []

    def size(self, id_bytes: bytes) -> int | None:
        """A blob's size without a copy."""
        total = self._lib.rt_ns_size(self._handle, self._key(id_bytes))
        return None if total < 0 else int(total)

    def is_spilled(self, id_bytes: bytes) -> bool:
        """Whether the only copy here is on disk."""
        return self._lib.rt_ns_spilled(self._handle,
                                       self._key(id_bytes)) == 1

    def read_chunk(self, id_bytes: bytes, offset: int,
                   length: int) -> tuple[int, "bytearray"] | None:
        """(total, the chunk) in one copy; the chunk is a bytearray, which
        pickles and joins as bytes do."""
        return self._read_into(self._key(id_bytes), offset, length)

    def stats(self) -> dict:
        out = (ctypes.c_uint64 * 9)()
        self._lib.rt_ns_stats(self._handle, out)
        return {"num_blobs": int(out[0]), "bytes": int(out[1]),
                "fetches_served": int(out[2]), "spilled_blobs": int(out[3]),
                "spilled_bytes": int(out[4]), "spills": int(out[5]),
                "restores": int(out[6]), "owners": int(out[7]),
                "native": True}

    def __del__(self):
        # Unreachable means no call is in flight (a call holds the store),
        # so the C++ store and its spill files go with it.
        try:
            if self._handle:
                self._lib.rt_ns_destroy(self._handle)
                self._handle = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def purge_stale_spills(spill_dir: str) -> None:
    """Delete the spill files of daemons that died (shared by the Python
    and native stores: the pid leads each file's name)."""
    from ray_tpu_torch._private.node_executor import _purge_stale_spills

    _purge_stale_spills(spill_dir)


def make_node_store(**kwargs):
    """A daemon's store: the native one when ``node_store_native`` is on
    and the managed spill tier (``spill_enabled``) is off, as in the
    reference (the watermark spiller needs the Python store's lease
    filter, segment twins and directory events); else the Python store.
    A failed native build raises."""
    from ray_tpu_torch._private import spill_manager
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    if bool(GLOBAL_CONFIG.node_store_native) and not spill_manager.SPILL_ON:
        from ray_tpu_torch._native import load

        return NativeNodeObjectStore(load(), **kwargs)
    from ray_tpu_torch._private.node_executor import NodeObjectStore

    return NodeObjectStore(**kwargs)
