"""Unique identifiers for runtime entities.

The port of ``ray_tpu/_private/ids.py``: every task, object, actor, node,
job and placement group gets 16 random bytes, printed as 32 hex digits.
"""

from __future__ import annotations

import os


class BaseID:
    """A 16-byte random identifier with a stable hex representation."""

    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes | None = None):
        if id_bytes is None:
            id_bytes = os.urandom(16)
        elif len(id_bytes) != 16:
            raise ValueError(f"{type(self).__name__} requires 16 bytes, "
                             f"got {len(id_bytes)}")
        self._bytes = id_bytes

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        # Cached: ids key several dict and set operations per task.
        try:
            return self._hash
        except AttributeError:
            h = self._hash = hash((type(self).__name__, self._bytes))
            return h

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class JobID(BaseID):
    pass


class NodeID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass
