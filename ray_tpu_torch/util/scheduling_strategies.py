"""The scheduling strategies a task or actor names in
``scheduling_strategy=``.

A copy of ``ray_tpu/util/scheduling_strategies.py``. The node label
strategy is declared for parity; ``@remote`` refuses it, as in the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    hard: dict | None = None
    soft: dict | None = None
