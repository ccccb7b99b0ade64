"""Placement groups: the user API.

The port of ``ray_tpu/util/placement_group.py``. ``placement_group``
reserves bundles of resources (``GPU`` among them) all or nothing;
tasks and actors scheduled with ``PlacementGroupSchedulingStrategy`` (or
``placement_group=``) take their demand from a bundle::

    pg = placement_group([{"GPU": 1, "CPU": 1}], strategy="STRICT_PACK")
    pg.wait(10)
    f.options(scheduling_strategy=PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)).remote()
    remove_placement_group(pg)
"""

from __future__ import annotations

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.object_ref import ObjectRef
from ray_tpu_torch.exceptions import GetTimeoutError


class PlacementGroup:
    """A handle to a placement group; it pickles to its id, its ready
    object, its bundles and its strategy."""

    def __init__(self, pg_id: PlacementGroupID, ready_ref: ObjectRef,
                 bundles: list[dict], strategy: str):
        self.id = pg_id
        self.ready_ref = ready_ref
        self.bundle_specs = bundles
        self.strategy = strategy

    def ready(self) -> ObjectRef:
        """The ObjectRef sealed once every bundle is committed."""
        return self.ready_ref

    def wait(self, timeout_seconds: float | None = None) -> bool:
        try:
            worker_mod.auto_init().get([self.ready_ref],
                                       timeout=timeout_seconds)
            return True
        except GetTimeoutError:
            return False

    @property
    def bundle_count(self) -> int:
        return len(self.bundle_specs)

    def __reduce__(self):
        return (PlacementGroup,
                (self.id, self.ready_ref, self.bundle_specs, self.strategy))


def placement_group(bundles: list[dict], strategy: str = "PACK",
                    name: str = "", lifetime: str | None = None
                    ) -> PlacementGroup:
    record = worker_mod.auto_init().placement_groups.create(
        bundles, strategy, name=name)
    return PlacementGroup(record.pg_id, ObjectRef(record.ready_object_id),
                          bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    worker_mod.auto_init().placement_groups.remove(pg.id)


def placement_group_table() -> dict:
    """The GCS table of groups, by id."""
    out = {}
    for record in worker_mod.auto_init().placement_groups.list():
        out[record.pg_id.hex()] = {
            "placement_group_id": record.pg_id.hex(),
            "name": record.name,
            "strategy": record.strategy,
            "state": record.state,
            "bundles": {i: dict(b.resources)
                        for i, b in enumerate(record.bundles)},
        }
    return out


def tpu_slice_bundle(num_chips: int, cpus_per_host: float = 8.0,
                     chips_per_host: int = 4) -> list[dict]:
    """Bundles reserving a whole TPU slice with STRICT_PACK semantics:
    one bundle per host, each holding that host's chips, so a slice is
    acquired all or nothing. On a node without ``TPU`` such a group
    stays pending, as any demand no node can meet does."""
    bundles = []
    remaining = num_chips
    while remaining > 0:
        chips = min(chips_per_host, remaining)
        bundles.append({"TPU": float(chips), "CPU": cpus_per_host})
        remaining -= chips
    return bundles
