"""The two clusters a mirrored node-layer case runs on: one per
package (``ray_tpu`` and ``ray_tpu_torch``), each a head in this process
with worker-node daemons as processes and a connected driver of no CPU.
Used by tests/test_torch_distributed_exec.py,
tests/test_torch_remote_actors.py and tests/test_torch_resource_sync.py.
"""

import importlib
import time
from dataclasses import dataclass
from types import ModuleType

import ray_tpu
import ray_tpu_torch

WAIT_S = 60.0


@dataclass
class Side:
    """One package's cluster and its names."""

    name: str
    rt: ModuleType
    runtime: object
    cluster: object
    tag_env: str
    pkg_cache: str

    @property
    def affinity(self):
        return self._mod("util.scheduling_strategies") \
            .NodeAffinitySchedulingStrategy

    def _mod(self, name: str) -> ModuleType:
        return importlib.import_module(f"{self.name}.{name}")

    def exceptions(self) -> ModuleType:
        return self._mod("exceptions")

    def node_executor(self) -> ModuleType:
        return self._mod("_private.node_executor")

    def remote_node_ids(self) -> list:
        with self.runtime._remote_nodes_lock:
            return list(self.runtime._remote_nodes)

    def handles(self) -> list:
        with self.runtime._remote_nodes_lock:
            return list(self.runtime._remote_nodes.values())


PACKAGES = {
    "ray_tpu": (ray_tpu, "RAY_TPU_NODE_TAG", "ray_tpu_pkg_cache"),
    "ray_tpu_torch": (ray_tpu_torch, "RAY_TPU_TORCH_NODE_TAG",
                      "ray_tpu_torch_pkg_cache"),
}


def wait_until(predicate, timeout: float = WAIT_S) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


def start_clusters(log_dir, nodes: list[dict], names=tuple(PACKAGES),
                   **cluster_kwargs) -> dict[str, Side]:
    """One cluster per package, each with a connected driver of no CPU
    that sees every node's CPU. The packages' daemons start one cluster
    after the other: a daemon's start is torch's import, and starting
    them all at once starves the host's other tests."""
    clusters, sides = {}, {}
    try:
        for name in names:
            rt, tag_env, pkg_cache = PACKAGES[name]
            rt.shutdown()
            cluster = clusters[name] = importlib.import_module(
                f"{name}.cluster_utils").Cluster(
                log_dir=str(log_dir / name), **cluster_kwargs)
            for node in nodes:
                cluster.add_node(**node)
            assert cluster.wait_for_nodes(len(nodes), timeout=WAIT_S), \
                f"{name}: daemons never registered"
            runtime = rt.init(num_cpus=0, address=cluster.address)
            want = sum(n.get("num_cpus", 2.0) for n in nodes)
            assert wait_until(
                lambda: rt.cluster_resources().get("CPU", 0) >= want), \
                f"{name}: the nodes never joined the driver's view"
            sides[name] = Side(name, rt, runtime, cluster, tag_env,
                               pkg_cache)
    except BaseException:
        stop_clusters(clusters)
        raise
    return sides


def stop_clusters(clusters: dict) -> None:
    for name, cluster in clusters.items():
        PACKAGES[name][0].shutdown()
        cluster.shutdown()


def both(scenario, sides: dict[str, Side]):
    """The scenario's record through both packages; they must agree."""
    records = {name: scenario(side) for name, side in sides.items()}
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]
