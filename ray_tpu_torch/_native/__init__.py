"""The port's native (C++) layer: the shared arena (``plasma_store.cpp``),
the daemon's blob store (``node_store.cpp``) and the head's KV engine
(``gcs_kv.cpp``), built with ``g++`` at first use and bound with
``ctypes``. They are host code, not kernels.

The port of ``ray_tpu/_native/__init__.py``, with these differences:

- The library is built into ``build/ray_tpu_torch/`` at the checkout's
  root, named by a hash of the sources and the flags, so an edited
  source gets a new file and a built library is never written again
  while a process has it mapped. The compiler writes a ``.<pid>.tmp``
  file that ``os.replace`` moves into place, under a file lock: many
  processes loading at once build it once, and none opens a
  half-written file.
- It links with ``-Wl,-Bsymbolic``: the JAX package's library exports the
  same ``rt_store_*``, ``rt_ns_*`` and ``gcs_kv_*`` symbols, and a
  process that loads both must bind each library's calls to its own.
- A failed build or ``dlopen`` raises, with the compiler's output. There
  is no fallback to the Python stores: the knobs ``object_arena_bytes=0``,
  ``node_store_native=False`` and ``gcs_kv_native=False`` are the only
  way onto those paths.

Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
SOURCES = tuple(_DIR / name for name in
                ("plasma_store.cpp", "node_store.cpp", "gcs_kv.cpp"))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-Wl,-Bsymbolic")
LINK_LIBS = ("-lpthread", "-lrt")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeLoadError(RuntimeError):
    """The native library could not be built or loaded."""


def library_path() -> Path:
    """Where the library is built: named by a hash of each source (name
    and bytes) and of the flags. Builds nothing."""
    digest = hashlib.sha256()
    for source in SOURCES:
        digest.update(source.name.encode())
        digest.update(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LINK_LIBS).encode())
    return BUILD_DIR / f"libray_tpu_torch_native-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Build the library unless it is built already; its path."""
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeLoadError(
            "g++ not found: the port's native arena, node store and KV "
            "engine need it (or turn them off: object_arena_bytes=0, "
            "node_store_native=False, gcs_kv_native=False)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if target.exists():  # another process built it meanwhile
            return target
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        try:
            try:
                done = subprocess.run(
                    [cxx, *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp),
                     *LINK_LIBS],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True, timeout=BUILD_TIMEOUT_S)
            except subprocess.TimeoutExpired as exc:
                raise NativeLoadError(
                    f"native build failed: g++ ran past {BUILD_TIMEOUT_S} "
                    f"s\n{_text(exc.output)}") from exc
            except OSError as exc:
                raise NativeLoadError(
                    f"native build failed: cannot run {cxx}: {exc}") from exc
            if done.returncode != 0:
                raise NativeLoadError(
                    f"native build failed: g++ exited {done.returncode}\n"
                    f"{done.stdout}")
            os.replace(tmp, target)
        finally:
            if tmp.exists():
                tmp.unlink()
    return target


def _text(output) -> str:
    """A timed-out run's output so far (bytes, text or None)."""
    if isinstance(output, bytes):
        return output.decode(errors="replace")
    return output or ""


def load() -> ctypes.CDLL:
    """The loaded native library, built first if needed. Raises
    ``NativeLoadError`` when it cannot be built or opened."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise NativeLoadError(f"cannot load {path}: {exc}") from exc
        _bind(lib)
        _lib = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    u64, u32, i64 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int64
    p, cp, cint = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(u64)
    size_t, long_ = ctypes.c_size_t, ctypes.c_long
    signatures = {
        # The shared arena (plasma_store.cpp).
        "rt_store_create": (p, [cp, u64, u32]),
        "rt_store_attach": (p, [cp]),
        "rt_store_detach": (None, [p]),
        "rt_store_destroy": (cint, [p, cp]),
        "rt_store_base": (u8p, [p]),
        "rt_store_mapped_size": (u64, [p]),
        "rt_store_create_object": (u64, [p, cp, u64]),
        "rt_store_seal": (cint, [p, cp]),
        "rt_store_seal_pinned": (cint, [p, cp]),
        "rt_store_get": (u64, [p, cp, u64p]),
        "rt_store_peek": (u64, [p, cp, u64p]),
        "rt_store_release": (cint, [p, cp]),
        "rt_store_delete": (cint, [p, cp]),
        "rt_store_contains": (cint, [p, cp]),
        "rt_store_stats": (None, [p] + [u64p] * 5),
        # The node store (node_store.cpp).
        "rt_ns_create": (p, [u64, u64, cp]),
        "rt_ns_destroy": (None, [p]),
        "rt_ns_put": (cint, [p, cp, cp, u64, cint, cp]),
        "rt_ns_read": (i64, [p, cp, u64, u8p, u64, u64p]),
        "rt_ns_size": (i64, [p, cp]),
        "rt_ns_spilled": (cint, [p, cp]),
        "rt_ns_free": (cint, [p, cp, u32]),
        "rt_ns_free_owner": (cint, [p, cp]),
        "rt_ns_owners": (i64, [p, cp, u64]),
        "rt_ns_stats": (None, [p, u64p]),
        # The head's KV engine (gcs_kv.cpp).
        "gcs_kv_create": (p, []),
        "gcs_kv_destroy": (None, [p]),
        "gcs_kv_version": (u64, [p]),
        "gcs_kv_put": (cint, [p, cp, cp, size_t, cp, size_t, cint]),
        "gcs_kv_get": (long_, [p, cp, cp, size_t, p, size_t]),
        "gcs_kv_del": (cint, [p, cp, cp, size_t]),
        "gcs_kv_exists": (cint, [p, cp, cp, size_t]),
        "gcs_kv_keys": (long_, [p, cp, cp, size_t, p, size_t]),
        "gcs_kv_snapshot": (long_, [p, p, size_t]),
        "gcs_kv_restore": (long_, [p, cp, size_t]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
