"""A cluster of node daemons on one machine.

The port of ``ray_tpu/cluster_utils.py``: a head in this process and
worker-node daemons as real OS processes, so scheduling, transfer and
failure are exercised without a real cluster::

    from ray_tpu_torch.cluster_utils import Cluster

    cluster = Cluster()
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2, resources={"GPU": 1})
    cluster.wait_for_nodes()
    ray_tpu_torch.init(num_cpus=0, address=cluster.address)
    ...  # tasks and actors now run on the daemons
    ray_tpu_torch.shutdown()
    cluster.shutdown()

Each daemon leads a process group of its own, with its worker pool and
its actors in it: removing a node ends the group, so no process of it
is left holding a card.

With ``persist_path`` the head is durable (snapshot, WAL and epoch) and
``restart_head()`` brings it back on the same port from that state;
``graceful=False`` is the crash shape (no last snapshot), so what comes
back is what the snapshot and the WAL held. The daemons re-register
under the new epoch with their NodeIDs.

Not ported: the autoscaler's fake provider and the YAML launcher of the
reference's cluster tooling (ROADMAP item 12).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field


@dataclass
class NodeHandle:
    """One worker-node daemon process."""

    proc: subprocess.Popen
    resources: dict = field(default_factory=dict)
    log_path: str = ""

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None


class Cluster:
    """A head in this process and worker-node daemons as processes."""

    def __init__(self, *, initialize_head: bool = True,
                 log_dir: str | None = None,
                 heartbeat_timeout_s: float = 10.0,
                 persist_path: str | None = None):
        import tempfile

        from ray_tpu_torch._private.gcs_server import GcsServer

        self._nodes: list[NodeHandle] = []
        self._added = 0
        self.gcs = None
        self._log_dir = log_dir or os.path.join(
            tempfile.gettempdir(), f"ray_tpu_torch_cluster_{os.getpid()}")
        os.makedirs(self._log_dir, exist_ok=True)
        self._heartbeat_timeout_s = heartbeat_timeout_s
        self._persist_path = persist_path
        if initialize_head:
            self.gcs = GcsServer(
                host="127.0.0.1", port=0, log_dir=self._log_dir,
                heartbeat_timeout_s=heartbeat_timeout_s,
                persist_path=persist_path).start()

    def restart_head(self, graceful: bool = False) -> None:
        """Stop the head and start it again on the same port from its
        persisted state. ``graceful=False``: the transport and the
        monitor stop with no last snapshot, as a SIGKILL leaves it."""
        from ray_tpu_torch._private.gcs_server import GcsServer

        if self.gcs is None:
            raise RuntimeError("cluster has no head")
        port = self.gcs._server.port
        if graceful:
            self.gcs.stop()
        else:
            self.gcs.crash()
        # The port may linger a moment: wait until it binds, so the new
        # head mints its epoch once.
        deadline = time.monotonic() + 10
        while True:
            probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                probe.bind(("127.0.0.1", port))
                break
            except OSError as exc:
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"head failed to rebind port {port}: {exc}") from exc
                time.sleep(0.2)
            finally:
                probe.close()
        self.gcs = GcsServer(
            host="127.0.0.1", port=port, log_dir=self._log_dir,
            heartbeat_timeout_s=self._heartbeat_timeout_s,
            persist_path=self._persist_path).start()

    @property
    def address(self) -> str:
        if self.gcs is None:
            raise RuntimeError("cluster has no head")
        return self.gcs.address

    # ------------------------------------------------------------ membership

    def add_node(self, *, num_cpus: float = 2.0,
                 resources: dict | None = None, pool_size: int = 2,
                 env: dict | None = None,
                 heartbeat_period_s: float | None = None) -> NodeHandle:
        """Start a worker-node daemon. With ``GPU`` in ``resources`` its
        ``CUDA_VISIBLE_DEVICES`` names the first cards this process sees
        (unless ``env`` sets it)."""
        from ray_tpu_torch._private.node import daemon_child_env
        from ray_tpu_torch._private.worker_pool import _visible_cards

        node_resources = {"CPU": float(num_cpus)}
        node_resources.update({k: float(v)
                               for k, v in (resources or {}).items()})
        extra = dict(env or {})
        gpus = node_resources.get("GPU", 0.0)
        if gpus > 0 and "CUDA_VISIBLE_DEVICES" not in extra:
            extra["CUDA_VISIBLE_DEVICES"] = _visible_cards(
                list(range(int(-(-gpus // 1)))))
        # The daemon stops if this process dies without removing it.
        kwargs = {"gcs_address": self.address, "resources": node_resources,
                  "pool_size": pool_size, "parent_pid": os.getpid()}
        if heartbeat_period_s is not None:
            kwargs["heartbeat_period_s"] = heartbeat_period_s
        self._added += 1
        log_path = os.path.join(self._log_dir,
                                f"daemon-{os.getpid()}-{self._added}.log")
        with open(log_path, "ab") as log_file:
            proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch._private.node",
                 "worker", json.dumps(kwargs)],
                env=daemon_child_env(extra), stdout=log_file,
                stderr=subprocess.STDOUT, start_new_session=True)
        handle = NodeHandle(proc=proc, resources=node_resources,
                            log_path=log_path)
        self._nodes.append(handle)
        return handle

    def remove_node(self, node: NodeHandle, *,
                    allow_graceful: bool = True) -> None:
        """Stop a daemon: SIGTERM lets it drain; without
        ``allow_graceful`` its whole process group gets SIGKILL, as a
        host crash would. Either way nothing of the group outlives this
        call."""
        if allow_graceful and node.alive():
            node.proc.terminate()
            try:
                node.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        try:
            os.killpg(node.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass  # the group has ended
        node.proc.wait(timeout=10)
        if node in self._nodes:
            self._nodes.remove(node)

    def wait_for_nodes(self, count: int | None = None,
                       timeout: float = 30.0) -> bool:
        """Wait until ``count`` (all added by default) daemons are
        registered with their executors."""
        from ray_tpu_torch._private.rpc import RpcClient, RpcError

        want = count if count is not None else len(self._nodes)
        client = RpcClient(self.address)
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                try:
                    nodes = client.call("list_nodes")
                except (RpcError, OSError):
                    nodes = []
                if sum(1 for n in nodes if n["alive"]
                       and n.get("executor_address")) >= want:
                    return True
                time.sleep(0.1)
            return False
        finally:
            client.close()

    @property
    def worker_nodes(self) -> list[NodeHandle]:
        return list(self._nodes)

    # ------------------------------------------------------------- lifecycle

    def shutdown(self) -> None:
        for node in list(self._nodes):
            try:
                self.remove_node(node)
            except Exception:  # noqa: BLE001 — the teardown must finish
                pass
        if self.gcs is not None:
            self.gcs.stop()
            self.gcs = None

    def __enter__(self) -> "Cluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
