"""Placement groups: gang reservation of resource bundles.

The port of ``ray_tpu/_private/placement_groups.py``. A group's bundles
are reserved all or nothing, in two phases (each bundle is taken from a
node in turn, and the whole reservation is committed only when every one
fits; otherwise what was taken goes back), by a thread that retries until
the group fits or is removed. The strategies place bundles over the
port's ``ClusterState``: PACK prefers the node of the first bundle,
SPREAD distinct nodes where it can, STRICT_PACK one node and
STRICT_SPREAD one node per bundle (on one node, a group of two or more
bundles stays pending). A bundle may hold ``GPU``, the port's own
resource.

Tasks and actors scheduled into a group take their demand from a
bundle's reservation (``acquire_from_bundle``) and give it back there
(``release_to_bundle``); the node's ledger does not see them. The group's
ready object is a store object, sealed when the group is committed. The
records live in the GCS table, which ``placement_group_table()`` reads.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ray_tpu_torch._private.accelerators import CardLedger
from ray_tpu_torch._private.ids import NodeID, ObjectID, PlacementGroupID
from ray_tpu_torch.exceptions import PlacementGroupError

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


@dataclass
class BundleReservation:
    bundle_index: int
    resources: dict[str, float]
    node_id: NodeID | None = None
    committed: bool = False
    # Resources lent out to tasks and actors scheduled in the bundle.
    in_use: dict[str, float] = field(default_factory=dict)
    # The card shares the bundle holds on its node, lent out in turn.
    cards: CardLedger | None = None


@dataclass
class PlacementGroupRecord:
    pg_id: PlacementGroupID
    bundles: list[BundleReservation]
    strategy: str
    name: str
    state: str = "PENDING"  # PENDING / CREATED / REMOVED
    ready_object_id: ObjectID | None = None


class PlacementGroupManager:
    """Two-phase (prepare, commit) bundle reservation over ClusterState."""

    def __init__(self, cluster, store, gcs):
        self._cluster = cluster
        self._store = store
        self._gcs = gcs
        self._lock = threading.Lock()

    def create(self, bundles: list[dict[str, float]], strategy: str,
               name: str = "") -> PlacementGroupRecord:
        if strategy not in VALID_STRATEGIES:
            raise ValueError(f"Invalid strategy {strategy!r}; must be one of "
                             f"{VALID_STRATEGIES}")
        if not bundles:
            raise ValueError("Placement group requires at least one bundle")
        for bundle in bundles:
            if not bundle or all(v == 0 for v in bundle.values()):
                raise ValueError(f"Invalid empty bundle: {bundle}")
        record = PlacementGroupRecord(
            pg_id=PlacementGroupID(),
            bundles=[BundleReservation(i, {k: float(v) for k, v in b.items()})
                     for i, b in enumerate(bundles)],
            strategy=strategy, name=name, ready_object_id=ObjectID())
        self._store.create_pending(record.ready_object_id)
        self._gcs.register_placement_group(record)
        # Reservation runs in the background; the ready object seals on
        # commit.
        threading.Thread(target=self._reserve_loop, args=(record,),
                         daemon=True,
                         name=f"ray_tpu_torch-pg-{record.pg_id.hex()[:8]}"
                         ).start()
        return record

    # ------------------------------------------------------------- placement

    def _reserve_loop(self, record: PlacementGroupRecord) -> None:
        while True:
            with self._lock:
                if record.state == "REMOVED":
                    return
            if self._try_reserve(record):
                with self._lock:
                    removed = record.state == "REMOVED"
                    if not removed:
                        record.state = "CREATED"
                if removed:
                    self._rollback(record)
                    return
                self._store.put(record.ready_object_id, None)
                return
            self._cluster.wait_for_change(0.05)

    def _try_reserve(self, record: PlacementGroupRecord) -> bool:
        """Phase 1, prepare: take every bundle or give back what was
        taken. Phase 2, commit."""
        placed: list[BundleReservation] = []
        used_nodes: set[NodeID] = set()
        for bundle in record.bundles:
            node = self._pick_bundle_node(record.strategy, bundle, used_nodes,
                                          placed)
            shares = None if node is None else self._cluster.try_acquire(
                node.node_id, bundle.resources)
            if shares is None:
                for taken in placed:
                    self._cluster.release(taken.node_id, taken.resources,
                                          taken.cards.capacity)
                    taken.node_id = None
                return False
            bundle.node_id = node.node_id
            bundle.cards = CardLedger(shares)
            placed.append(bundle)
            used_nodes.add(node.node_id)
        for bundle in record.bundles:
            bundle.committed = True
        return True

    def _pick_bundle_node(self, strategy: str, bundle, used_nodes, placed):
        if strategy == "STRICT_PACK":
            if placed:
                node = self._cluster.get_node(placed[0].node_id)
                return node if node and node.fits(bundle.resources) else None
            return self._cluster.pick_node(bundle.resources, None)
        if strategy == "STRICT_SPREAD":
            return self._cluster.pick_node(bundle.resources, None,
                                           exclude=used_nodes)
        if strategy == "SPREAD":
            return self._cluster.pick_node(
                bundle.resources, None, exclude=used_nodes) \
                or self._cluster.pick_node(bundle.resources, None)
        # PACK: prefer the node of the earlier bundles.
        if placed:
            node = self._cluster.get_node(placed[0].node_id)
            if node is not None and node.fits(bundle.resources):
                return node
        return self._cluster.pick_node(bundle.resources, None)

    # ------------------------------------------------------------ bundle use

    def _candidates(self, record, bundle_index: int):
        return record.bundles if bundle_index < 0 \
            else [record.bundles[bundle_index]]

    def unplaceable(self, pg_id: PlacementGroupID, bundle_index: int,
                    demand: dict[str, float]) -> str | None:
        """Why ``demand`` can never be taken from the group's bundle
        (``bundle_index`` -1: any bundle), or None while it may be."""
        record = self._gcs.get_placement_group(pg_id)
        if record is None or record.state == "REMOVED":
            return f"placement group {pg_id.hex()} was removed"
        if bundle_index >= len(record.bundles):
            return (f"placement group {pg_id.hex()} has no bundle "
                    f"{bundle_index} ({len(record.bundles)} bundles)")
        if not any(all(b.resources.get(k, 0.0) + 1e-9 >= v
                       for k, v in demand.items())
                   for b in self._candidates(record, bundle_index)):
            return (f"{demand} exceeds placement group {pg_id.hex()} "
                    f"bundle {bundle_index}")
        return None

    def acquire_from_bundle(self, pg_id: PlacementGroupID, bundle_index: int,
                            demand: dict[str, float]
                            ) -> tuple[NodeID, dict[int, float]]:
        """Lend ``demand`` from a committed bundle to a task or actor;
        its node and the card shares of its GPU. Raises
        PlacementGroupError when the group is not ready or no bundle has
        room now."""
        with self._lock:
            record = self._gcs.get_placement_group(pg_id)
            if record is None or record.state != "CREATED":
                raise PlacementGroupError(
                    f"Placement group {pg_id.hex()} is not ready")
            for bundle in self._candidates(record, bundle_index):
                shares = bundle.cards.pick(demand.get("GPU", 0.0))
                if shares is not None and all(
                        bundle.resources.get(k, 0.0)
                        - bundle.in_use.get(k, 0.0) + 1e-9 >= v
                        for k, v in demand.items()):
                    bundle.cards.take(shares)
                    for k, v in demand.items():
                        bundle.in_use[k] = bundle.in_use.get(k, 0.0) + v
                    return bundle.node_id, shares
            raise PlacementGroupError(
                f"No capacity in placement group {pg_id.hex()} bundle "
                f"{bundle_index} for {demand}")

    def release_to_bundle(self, pg_id: PlacementGroupID, bundle_index: int,
                          demand: dict[str, float],
                          shares: dict[int, float]) -> None:
        """Give a task's or actor's share back to its bundle, or to the
        bundle's node once the group is removed."""
        to_node = None
        with self._lock:
            record = self._gcs.get_placement_group(pg_id)
            if record is None:
                return
            for bundle in self._candidates(record, bundle_index):
                if all(bundle.in_use.get(k, 0.0) + 1e-9 >= v
                       for k, v in demand.items()) \
                        and all(i in bundle.cards.capacity for i in shares):
                    for k, v in demand.items():
                        bundle.in_use[k] = bundle.in_use.get(k, 0.0) - v
                    if record.state == "REMOVED":
                        to_node = bundle.node_id
                    else:
                        bundle.cards.give(shares)
                    break
        if to_node is not None:
            self._cluster.release(to_node, demand, shares)
        else:
            self._cluster.notify_change()

    # ---------------------------------------------------------------- remove

    def remove(self, pg_id: PlacementGroupID) -> None:
        """The group's reservation goes back to its nodes, what its
        running tasks and actors hold as each lets go of it."""
        with self._lock:
            record = self._gcs.get_placement_group(pg_id)
            if record is None or record.state == "REMOVED":
                return
            was_created = record.state == "CREATED"
            record.state = "REMOVED"
        if was_created:
            self._rollback(record)

    def _rollback(self, record: PlacementGroupRecord) -> None:
        """Give each committed bundle's free part back to its node; the
        part its tasks and actors hold follows when they release it."""
        for bundle in record.bundles:
            if bundle.node_id is not None and bundle.committed:
                bundle.committed = False
                self._cluster.release(bundle.node_id, {
                    k: v - bundle.in_use.get(k, 0.0)
                    for k, v in bundle.resources.items()},
                    {i: f for i, f in bundle.cards.free.items() if f > 0})

    def shutdown(self) -> None:
        """Remove every group: their reservation threads end."""
        for record in self.list():
            self.remove(record.pg_id)

    def get(self, pg_id: PlacementGroupID) -> PlacementGroupRecord | None:
        return self._gcs.get_placement_group(pg_id)

    def list(self) -> list[PlacementGroupRecord]:
        return self._gcs.list_placement_groups()
