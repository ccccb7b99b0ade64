"""Checkpoints: a directory each, with ``torch.distributed.checkpoint``
for the tensors.

The port of ``ray_tpu/train/checkpoint.py``. Where the reference saves a
pytree of (possibly sharded) arrays through orbax, ``from_state`` saves
a state's tensors (plain, or DTensors with their placements) through
``torch.distributed.checkpoint`` (DCP) and its structure and Python
scalars (a ``TrainState``'s step, the optimizer's count) in
``meta.json``. ``to_state(template)`` loads into new tensors on the
template's devices and placements, as orbax restores into a template;
without a template it returns the state as plain CPU tensors, a
dataclass as a dict of its fields. A failed save raises: DCP is part of
torch, so there is no other format to fall back to.

Top-K retention (``CheckpointManager``) is the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import shutil
import tempfile
import threading
import time
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

# One save or load at a time in a process: the workers of a thread gang
# share the default process group, and DCP plans its I/O with
# collectives on it, which two threads must not interleave. Without a
# process group DCP runs in one process (no_dist).
_DCP_LOCK = threading.Lock()


def _flatten(tree: Any, path: tuple, tensors: dict) -> dict:
    """The structure of ``tree`` as JSON, its tensors put into
    ``tensors`` under their '/'-joined paths."""
    where = "/".join(path)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {"fields": {f.name: _flatten(getattr(tree, f.name),
                                            path + (f.name,), tensors)
                           for f in dataclasses.fields(tree)}}
    if isinstance(tree, dict):
        if not all(isinstance(k, str) for k in tree):
            raise TypeError(f"checkpoint dict keys must be str at "
                            f"{where!r}")
        return {"dict": {k: _flatten(v, path + (k,), tensors)
                         for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_flatten(v, path + (str(i),), tensors)
                       for i, v in enumerate(tree)]}
    if isinstance(tree, torch.Tensor):
        tensors[where] = tree.detach()
        return {"tensor": where}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                    f"{where!r}")


def _unflatten(node: dict, tensors: dict) -> Any:
    if "fields" in node:
        return {k: _unflatten(v, tensors) for k, v in node["fields"].items()}
    if "dict" in node:
        return {k: _unflatten(v, tensors) for k, v in node["dict"].items()}
    if "list" in node:
        return [_unflatten(v, tensors) for v in node["list"]]
    if "tuple" in node:
        return tuple(_unflatten(v, tensors) for v in node["tuple"])
    if "tensor" in node:
        return tensors[node["tensor"]]
    return node["value"]


def _rebuild(template: Any, node: dict, tensors: dict) -> Any:
    """``template``'s structure, its tensors taken from ``tensors`` and
    its scalars from the saved ``node``."""
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), node["fields"][f.name],
                             tensors) for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(v, node["dict"][k], tensors)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = node["list" if isinstance(template, list) else "tuple"]
        return type(template)(_rebuild(v, n, tensors)
                              for v, n in zip(template, items, strict=True))
    if isinstance(template, torch.Tensor):
        return tensors[node["tensor"]].requires_grad_(template.requires_grad)
    return node["value"]


class Checkpoint:
    """A directory of checkpoint data."""

    def __init__(self, path: str):
        self.path = path

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(os.path.abspath(path))

    @classmethod
    def from_dict(cls, data: dict) -> "Checkpoint":
        tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        with open(os.path.join(tmp, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(tmp)

    def to_dict(self) -> dict:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def as_directory(self) -> str:
        return self.path

    # ------------------------------------------------ tensor state (DCP)

    @classmethod
    def from_state(cls, state: Any, path: str | None = None) -> "Checkpoint":
        """Save a state: nested dicts, lists and dataclasses (a
        ``TrainState``) of tensors or DTensors and Python scalars. The
        default directory is a new one under the temporary directory."""
        target = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(target, exist_ok=True)
        tensors: dict = {}
        tree = _flatten(state, (), tensors)
        with _DCP_LOCK:
            dcp.save(tensors, checkpoint_id=os.path.join(target, "state"),
                     no_dist=not dist.is_initialized())
        with open(os.path.join(target, "meta.json"), "w") as f:
            json.dump({"format": "dcp", "tree": tree}, f)
        return cls(target)

    def to_state(self, template: Any | None = None) -> Any:
        """The saved state: into new tensors like ``template``'s (same
        devices, dtypes and placements; its structure), or without one
        as plain CPU tensors."""
        with open(os.path.join(self.path, "meta.json")) as f:
            tree = json.load(f)["tree"]
        state_dir = os.path.join(self.path, "state")
        if template is None:
            saved = dcp.FileSystemReader(state_dir).read_metadata()
            targets = {key: torch.empty(md.size, dtype=md.properties.dtype)
                       for key, md in saved.state_dict_metadata.items()}
        else:
            like: dict = {}
            _flatten(template, (), like)
            targets = {key: torch.empty_like(t) for key, t in like.items()}
        if targets:
            with _DCP_LOCK:
                dcp.load(targets, checkpoint_id=state_dir,
                         no_dist=not dist.is_initialized())
        if template is None:
            return _unflatten(tree, targets)
        return _rebuild(template, tree, targets)

    def __repr__(self):
        return f"Checkpoint({self.path})"


class CheckpointManager:
    """Top-K checkpoint retention (reference:
    train/_internal/checkpoint_manager.py)."""

    def __init__(self, storage_path: str, num_to_keep: int | None = None,
                 metric: str | None = None, mode: str = "max"):
        self.storage_path = storage_path
        self.num_to_keep = num_to_keep
        self.metric = metric
        self.mode = mode
        # (score, seq, path, metrics); seq is a monotonic counter so names
        # never collide and "latest" is insertion order.
        self._entries: list[tuple[float, int, str, dict]] = []
        self._seq = 0
        os.makedirs(storage_path, exist_ok=True)

    def register(self, checkpoint: Checkpoint, metrics: dict) -> str:
        """Move a checkpoint into managed storage (a rename where both
        lie on one file system); evict beyond top-K."""
        seq = self._seq
        self._seq += 1
        name = f"checkpoint_{int(time.time() * 1000):x}_{seq:08d}"
        dest = os.path.join(self.storage_path, name)
        if os.path.abspath(checkpoint.path) != os.path.abspath(dest):
            shutil.move(checkpoint.path, dest)
        score = metrics.get(self.metric, 0.0) if self.metric else float(seq)
        if self.mode == "min":
            score = -score
        self._entries.append((score, seq, dest, dict(metrics)))
        self._entries.sort(key=lambda e: (e[0], e[1]), reverse=True)
        if self.num_to_keep is not None:
            while len(self._entries) > self.num_to_keep:
                _, _, evict_path, _ = self._entries.pop()
                shutil.rmtree(evict_path, ignore_errors=True)
        return dest

    def best_checkpoint(self) -> Checkpoint | None:
        if not self._entries:
            return None
        return Checkpoint(self._entries[0][2])

    def latest_checkpoint(self) -> Checkpoint | None:
        if not self._entries:
            return None
        latest = max(self._entries, key=lambda e: e[1])
        return Checkpoint(latest[2])
