"""Shipping a runtime env's directories to the nodes that run a task.

The port of the directory half of
``ray_tpu/_private/runtime_env_packaging.py``: a ``working_dir`` or
``py_modules`` directory of a connected driver becomes a content-hashed
zip, put once into the driver's export store; a node that runs the task
pulls it through the same chunked ``fetch_object`` path arguments take,
extracts it once into its package cache, and the worker sees the
extracted path. The runtime env entry travels as
``{"__pkg__": [hash, export address, member]}``. The pip half waits for
ROADMAP item 12 with the pip and conda envs.
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import tempfile
import zipfile

_EXCLUDE_DIRS = {"__pycache__", ".git"}
_MAX_PACKAGE_BYTES = 512 * 1024 * 1024


def _cache_root() -> str:
    return os.environ.get(
        "RAY_TPU_TORCH_PKG_CACHE",
        os.path.join(tempfile.gettempdir(), "ray_tpu_torch_pkg_cache"))


def _entries(path: str) -> list[tuple[str, str]]:
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env path {path!r} is not a directory")
    out = []
    for root, dirs, files in os.walk(path):
        dirs[:] = sorted(d for d in dirs if d not in _EXCLUDE_DIRS)
        for name in sorted(files):
            if not name.endswith(".pyc"):
                full = os.path.join(root, name)
                out.append((os.path.relpath(full, path), full))
    return out


def hash_directory(path: str) -> str:
    """The content hash ``package_directory`` gives, without zipping."""
    hasher = hashlib.sha1()
    for rel, full in _entries(path):
        hasher.update(rel.encode())
        with open(full, "rb") as f:
            hasher.update(f.read())
    return hasher.hexdigest()


def package_directory(path: str) -> tuple[str, bytes]:
    """(content hash, zip bytes), deterministic: sorted entries and
    fixed timestamps, so the hash is stable and caches hit."""
    buf = io.BytesIO()
    hasher = hashlib.sha1()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in _entries(path):
            with open(full, "rb") as f:
                data = f.read()
            hasher.update(rel.encode())
            hasher.update(data)
            info = zipfile.ZipInfo(rel, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = (os.stat(full).st_mode & 0xFFFF) << 16
            zf.writestr(info, data)
    blob = buf.getvalue()
    if len(blob) > _MAX_PACKAGE_BYTES:
        raise ValueError(f"runtime_env package for {path!r} is {len(blob)} "
                         f"bytes (limit {_MAX_PACKAGE_BYTES})")
    return hasher.hexdigest(), blob


def ensure_package_local(hash_hex: str, export_addr: str,
                         member: str | None = None) -> str:
    """The extracted package, pulled from the owner's export store the
    first time this node needs it. A py_modules package keeps its
    directory's name (``member``) so that it imports by it."""
    from ray_tpu_torch._private.node_executor import fetch_blob
    from ray_tpu_torch._private.rpc import RpcClient

    target = os.path.join(_cache_root(),
                          hash_hex + (f"-{member}" if member else ""))
    inner = os.path.join(target, member) if member else target
    if os.path.exists(os.path.join(target, ".complete")):
        return inner
    client = RpcClient(export_addr, timeout_s=120.0)
    try:
        blob = fetch_blob(client, bytes.fromhex(hash_hex))
    finally:
        client.close()
    tmp = f"{target}.tmp.{os.getpid()}.{os.urandom(3).hex()}"
    extract_to = os.path.join(tmp, member) if member else tmp
    os.makedirs(extract_to, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(extract_to)
    open(os.path.join(tmp, ".complete"), "w").close()
    try:
        os.rename(tmp, target)
    except OSError:
        # A concurrent extraction won the rename.
        shutil.rmtree(tmp, ignore_errors=True)
    return inner


def resolve_runtime_env(renv: dict | None) -> dict | None:
    """Replace package markers with the local extracted paths."""
    if not renv:
        return renv

    def resolve(value):
        if isinstance(value, dict) and "__pkg__" in value:
            return ensure_package_local(*value["__pkg__"])
        return value

    out = dict(renv)
    if "working_dir" in out:
        out["working_dir"] = resolve(out["working_dir"])
    if out.get("py_modules"):
        out["py_modules"] = [resolve(m) for m in out["py_modules"]]
    return out
