"""The serialization boundary of the multiprocess runtime.

The port of ``ray_tpu/_private/serialization.py``: pickle protocol 5
with out-of-band buffers, a framed single-buffer layout that drops whole
into one shared-memory segment, the raw small-immutable framing, and
``dumps_function`` for code. Layout of a framed object (lengths are
little-endian uint64)::

    [header_len][header][n_buffers]
    [pad][buf_0 len][buf_0] ... [pad][buf_{n-1} len][buf_{n-1}]

Each buffer starts 64-byte aligned from the start of the frame (the
reference's layout has no padding): a tensor viewing a segment is then
aligned for its dtype. ``deserialize_from_buffer`` hands the buffers out
as views of the source, so arrays and tensors come back zero-copy.

Where the reference uses ``cloudpickle``, the port keeps its own
by-value pickler (``_Pickler``): a function or class that cannot be
imported by name on the other side (one defined in ``__main__``, inside
a function, or a lambda) goes by value: its code object through
``marshal`` (both ends run the same interpreter), the globals it names,
its defaults, its closure cells, and a class's body. Everything
importable goes by reference, modules included.

Tensors are reduced here, never by torch's own reduction (it restores a
CUDA tensor onto ``cuda`` through ``torch.load``, which fails in a
process without a card) nor ``torch.multiprocessing``'s (it puts a CUDA
IPC handle into the pickle). A tensor becomes one out-of-band buffer of
its bytes plus dtype, shape and stride; a CUDA tensor takes one
device-to-host copy after the card is synchronized. On load it comes
back on ``cuda`` in a process that sees a card and on the CPU in one
that does not, as a ``jax.Array`` comes back on the receiver's default
device in the reference.
"""

from __future__ import annotations

import builtins
import importlib
import io
import marshal
import pickle
import struct
import sys
import threading
import types
import uuid
import weakref
from typing import Any

import numpy as np
import torch

_U64 = struct.Struct("<Q")
_ALIGN = 64

# Raw small-immutable framing (the worker-pipe fast path): eligible
# values are encoded with a compact tag-length scheme instead of a
# pickle round trip. A raw frame starts with a header length no pickled
# frame can produce (2**64 - 1), so readers tell the two layouts apart
# from the first 8 bytes; only producing raw frames is gated (RAW_ON,
# armed from the raw_framing knob).
RAW_ON: bool = True
_RAW_SENTINEL = (1 << 64) - 1
_RAW_SENTINEL_BYTES = _U64.pack(_RAW_SENTINEL)
_RAW_MAX_BYTES = 8192
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


def init_raw_from_config() -> None:
    """Arm or disarm the raw framing from the ``raw_framing`` knob."""
    global RAW_ON
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    RAW_ON = bool(GLOBAL_CONFIG.raw_framing)


init_raw_from_config()


class _RawIneligible(Exception):
    """The value holds a type the raw encoding has no tag for, or is too
    large: the caller takes the pickle path."""


_scratch = threading.local()


def _raw_encode(out: bytearray, value: Any) -> None:
    # Exact types only: subclasses must keep their type through pickle.
    t = type(value)
    if value is None:
        out.append(0x4E)
    elif t is bool:
        out.append(0x54 if value else 0x46)
    elif t is int:
        if not _I64_MIN <= value <= _I64_MAX:
            raise _RawIneligible
        out.append(0x69)
        out += _I64.pack(value)
    elif t is float:
        out.append(0x66)
        out += _F64.pack(value)
    elif t is str:
        b = value.encode("utf-8")
        out.append(0x73)
        out += _U32.pack(len(b))
        out += b
    elif t is bytes:
        out.append(0x62)
        out += _U32.pack(len(value))
        out += value
    elif t is tuple:
        out.append(0x74)
        out += _U32.pack(len(value))
        for item in value:
            _raw_encode(out, item)
    elif t is dict:
        out.append(0x64)
        out += _U32.pack(len(value))
        for k, v in value.items():
            if type(k) is not str:
                raise _RawIneligible
            kb = k.encode("utf-8")
            out += _U32.pack(len(kb))
            out += kb
            _raw_encode(out, v)
    else:
        raise _RawIneligible
    if len(out) > _RAW_MAX_BYTES:
        raise _RawIneligible


def try_serialize_raw(value: Any) -> "bytes | None":
    """``value`` in the raw encoding, or None when it is ineligible or
    the fast path is disarmed; ``deserialize_from_buffer`` reads both."""
    if not RAW_ON:
        return None
    out = getattr(_scratch, "buf", None)
    if out is None:
        out = _scratch.buf = bytearray()
    else:
        del out[:]
    out += _RAW_SENTINEL_BYTES
    try:
        _raw_encode(out, value)
    except _RawIneligible:
        return None
    return bytes(out)


def _raw_decode(source: memoryview, off: int) -> tuple[Any, int]:
    tag = source[off]
    off += 1
    if tag == 0x4E:
        return None, off
    if tag == 0x54:
        return True, off
    if tag == 0x46:
        return False, off
    if tag == 0x69:
        return _I64.unpack(source[off:off + 8])[0], off + 8
    if tag == 0x66:
        return _F64.unpack(source[off:off + 8])[0], off + 8
    if tag in (0x73, 0x62):
        (n,) = _U32.unpack(source[off:off + 4])
        off += 4
        raw = source[off:off + n]
        return (str(raw, "utf-8") if tag == 0x73 else bytes(raw)), off + n
    if tag in (0x74, 0x64):
        (n,) = _U32.unpack(source[off:off + 4])
        off += 4
        if tag == 0x74:
            items = []
            for _ in range(n):
                item, off = _raw_decode(source, off)
                items.append(item)
            return tuple(items), off
        d = {}
        for _ in range(n):
            (kn,) = _U32.unpack(source[off:off + 4])
            off += 4
            key = str(source[off:off + kn], "utf-8")
            off += kn
            d[key], off = _raw_decode(source, off)
        return d, off
    raise ValueError(f"corrupt raw frame: unknown tag {tag:#x}")


# --------------------------------------------------------------------------
# The by-value pickler
# --------------------------------------------------------------------------


def _lookup(module_name: str, qualname: str):
    obj = sys.modules.get(module_name)
    if obj is None:
        return None
    for part in qualname.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return obj


def _by_reference(obj) -> bool:
    """Whether ``obj`` (a function or class) is importable by name in a
    process that imports its module."""
    module = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", "")
    if module in (None, "__main__") or "<" in qualname:
        return False
    return _lookup(module, qualname) is obj


def _code_names(code: types.CodeType, out: set) -> set:
    out.update(code.co_names)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _code_names(const, out)
    return out


def _make_function(code_bytes: bytes, base_globals: dict, name: str,
                   closure: tuple | None):
    base_globals.setdefault("__builtins__", builtins)
    return types.FunctionType(marshal.loads(code_bytes), base_globals, name,
                              None, closure)


def _function_setstate(func, state: dict) -> None:
    func.__globals__.update(state.pop("__globals__"))
    for key, value in state.items():
        setattr(func, key, value)


def _make_cell():
    return types.CellType()


def _cell_setstate(cell, state: tuple) -> None:
    # () for an empty cell; a 1-tuple otherwise (pickle never applies a
    # state of None).
    if state:
        cell.cell_contents = state[0]


# Classes sent by value keep their identity in the receiver: the same
# class pickled twice (an actor class, then an instance it returns)
# comes back as one class object.
_class_ids: "weakref.WeakKeyDictionary[type, str]" = weakref.WeakKeyDictionary()
_classes_by_id: dict[str, type] = {}
_class_lock = threading.Lock()


def _class_id(cls: type) -> str:
    with _class_lock:
        cid = _class_ids.get(cls)
        if cid is None:
            cid = _class_ids[cls] = uuid.uuid4().hex
            _classes_by_id[cid] = cls
        return cid


def _make_class(metaclass, name: str, bases: tuple, namespace: dict,
                cid: str):
    with _class_lock:
        known = _classes_by_id.get(cid)
        if known is not None:
            return known
        cls = types.new_class(name, bases, {"metaclass": metaclass},
                              lambda ns: ns.update(namespace))
        _classes_by_id[cid] = cls
        _class_ids[cls] = cid
        return cls


def _class_setstate(cls, state: dict) -> None:
    for key, value in state.items():
        setattr(cls, key, value)
        set_name = getattr(type(value), "__set_name__", None)
        if set_name is not None:
            set_name(value, cls, key)


_SKIP_CLASS_ATTRS = {"__dict__", "__weakref__", "_abc_impl"}


def _rebuild_tensor(buf, dtype: torch.dtype, shape: tuple, stride: tuple,
                    contiguous: bool, requires_grad: bool, on_cuda: bool,
                    is_param: bool) -> torch.Tensor:
    view = memoryview(buf).cast("B")
    if view.readonly:
        # A tensor must never write into an immutable buffer.
        view = memoryview(bytearray(view))
    if view.nbytes:
        flat = torch.frombuffer(view, dtype=torch.uint8)
        t = flat.view(dtype).reshape(shape)
    else:
        t = torch.empty(shape, dtype=dtype)
    if not contiguous:
        t = torch.empty_strided(shape, stride, dtype=dtype).copy_(t)
    if on_cuda and sees_card():
        t = t.to("cuda")
    if is_param:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


_SEES_CARD: "bool | None" = None


def sees_card() -> bool:
    """Whether this process sees a CUDA card (asked once)."""
    global _SEES_CARD
    if _SEES_CARD is None:
        _SEES_CARD = torch.cuda.is_available()
    return _SEES_CARD


def _reduce_tensor(t: torch.Tensor):
    if type(t) not in (torch.Tensor, torch.nn.Parameter) \
            or t.layout != torch.strided or t.device.type not in ("cpu",
                                                                  "cuda"):
        return NotImplemented
    if t.requires_grad and not t.is_leaf:
        raise RuntimeError("cannot send a non-leaf tensor that requires "
                           "grad across the process boundary; detach it")
    src = t.detach()
    on_cuda = src.device.type == "cuda"
    if on_cuda:
        torch.cuda.synchronize(src.device)
        src = src.cpu()
    contiguous = src.is_contiguous()
    if not contiguous:
        src = src.contiguous()
    data = src.reshape(-1).view(torch.uint8).numpy() if src.numel() \
        else np.empty(0, np.uint8)
    return (_rebuild_tensor,
            (pickle.PickleBuffer(data), t.dtype, tuple(t.shape),
             tuple(t.stride()), contiguous, t.requires_grad, on_cuda,
             type(t) is torch.nn.Parameter))


class _Pickler(pickle.Pickler):
    """Protocol 5 with functions and classes by value where they cannot
    be imported, modules by name, and tensors reduced to their bytes."""

    def __init__(self, file, buffer_callback=None):
        super().__init__(file, protocol=5, buffer_callback=buffer_callback)
        # One globals dict per module per pickle: functions of one module
        # share it again on the other side.
        self._globals: dict[int, dict] = {}

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _reduce_tensor(obj)
        t = type(obj)
        if t is types.FunctionType:
            return NotImplemented if _by_reference(obj) \
                else self._reduce_function(obj)
        if issubclass(t, type):
            return NotImplemented if _by_reference(obj) \
                or obj.__module__ == "builtins" else self._reduce_class(obj)
        if t is types.ModuleType:
            if obj.__name__ == "__main__":
                raise pickle.PicklingError("cannot pickle module __main__")
            return importlib.import_module, (obj.__name__,)
        if t is types.CellType:
            try:
                state = (obj.cell_contents,)
            except ValueError:
                state = ()
            return _make_cell, (), state, None, None, _cell_setstate
        if t is property:
            return property, (obj.fget, obj.fset, obj.fdel, obj.__doc__)
        if t in (staticmethod, classmethod):
            return t, (obj.__func__,)
        return NotImplemented

    def _reduce_function(self, func):
        code = func.__code__
        gl = func.__globals__
        base = self._globals.setdefault(
            id(gl), {"__name__": gl.get("__name__"),
                     "__package__": gl.get("__package__")})
        names = _code_names(code, set())
        state = {
            "__globals__": {n: gl[n] for n in names if n in gl},
            "__defaults__": func.__defaults__,
            "__kwdefaults__": func.__kwdefaults__,
            "__qualname__": func.__qualname__,
            "__module__": func.__module__,
            "__doc__": func.__doc__,
            "__dict__": dict(func.__dict__),
        }
        return (_make_function,
                (marshal.dumps(code), base, func.__name__, func.__closure__),
                state, None, None, _function_setstate)

    def _reduce_class(self, cls):
        namespace = {"__module__": cls.__module__,
                     "__qualname__": cls.__qualname__}
        slots = cls.__dict__.get("__slots__")
        skip = set(_SKIP_CLASS_ATTRS)
        if slots is not None:
            namespace["__slots__"] = slots
            skip.update([slots] if isinstance(slots, str) else slots)
        state = {k: v for k, v in cls.__dict__.items()
                 if k not in skip and k not in namespace}
        return (_make_class,
                (type(cls), cls.__name__, cls.__bases__, namespace,
                 _class_id(cls)),
                state, None, None, _class_setstate)


def serialize(value: Any) -> tuple[bytes, list[pickle.PickleBuffer]]:
    """Pickle with out-of-band buffers (zero-copy for arrays and
    tensors)."""
    buffers: list[pickle.PickleBuffer] = []
    out = io.BytesIO()
    _Pickler(out, buffer_callback=buffers.append).dump(value)
    return out.getvalue(), buffers


def _padding(off: int) -> int:
    return -off % _ALIGN


def framed_size(header: bytes, buffers: list) -> int:
    total = _U64.size * 2 + len(header)
    for buf in buffers:
        total += _padding(total) + _U64.size
        total += _padding(total) + memoryview(buf).nbytes
    return total


def write_framed(target: memoryview, header: bytes, buffers: list) -> int:
    """Write the framed layout into ``target``; the bytes written."""
    off = 0

    def put(b) -> None:
        nonlocal off
        m = memoryview(b)
        if m.ndim != 1 or m.format != "B":
            m = m.cast("B")
        target[off:off + m.nbytes] = m
        off += m.nbytes

    put(_U64.pack(len(header)))
    put(header)
    put(_U64.pack(len(buffers)))
    for buf in buffers:
        m = memoryview(buf)
        off += _padding(off)
        put(_U64.pack(m.nbytes))
        off += _padding(off)
        put(m)
    return off


def serialize_framed(value: Any) -> bytes:
    header, buffers = serialize(value)
    out = bytearray(framed_size(header, buffers))
    write_framed(memoryview(out), header, buffers)
    return bytes(out)


def deserialize_from_buffer(source: memoryview) -> Any:
    """Read the framed layout; the buffers are views of ``source``. A
    raw frame (sentinel header length) decodes through the tag scheme."""
    if len(source) >= 8 and bytes(source[:8]) == _RAW_SENTINEL_BYTES:
        return _raw_decode(source, 8)[0]
    (header_len,) = _U64.unpack(source[:8])
    off = 8 + header_len
    header = source[8:off]
    (n_buffers,) = _U64.unpack(source[off:off + 8])
    off += 8
    buffers = []
    for _ in range(n_buffers):
        off += _padding(off)
        (buf_len,) = _U64.unpack(source[off:off + 8])
        off += 8
        off += _padding(off)
        buffers.append(source[off:off + buf_len])
        off += buf_len
    return pickle.loads(header, buffers=buffers)


def dumps_function(func: Any) -> bytes:
    """Pickle code (functions, classes, closures) by value where it
    cannot be imported by name: the function-manager boundary."""
    out = io.BytesIO()
    _Pickler(out).dump(func)
    return out.getvalue()


def loads_function(blob: bytes) -> Any:
    return pickle.loads(blob)
