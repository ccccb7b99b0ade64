"""Node agents and the head and worker daemons.

The port of ``ray_tpu/_private/node.py``. A cluster is one head (a
``GcsServer``, the control plane) and worker-node daemons: each runs a
``NodeExecutorService`` and a ``NodeAgent`` that registers the node's
resources with the head and heartbeats. A daemon is started as

    python -m ray_tpu_torch._private.node worker '{"gcs_address": ...,
        "resources": {"CPU": 2, "GPU": 1}, "pool_size": 2}'

(``cluster_utils.Cluster.add_node`` does this). Its ``GPU`` count is
what ``accelerators.detect_resources()`` finds (``torch.cuda`` unless
``RAY_TPU_TORCH_NUM_GPUS`` says otherwise): a daemon that declares more
``GPU`` than it sees refuses to start, and never runs ``GPU`` work on
the CPU.

The head persists its tables to ``<session dir>/gcs_snapshot.pkl`` (a
snapshot and its WAL) and mints an epoch at each start; an agent that
sees a new epoch on any reply, or whose heartbeat is refused with
``StaleEpochError``, registers again asking to keep its NodeID, so a
daemon rides a head restart without losing its id, its actors or the
results in its store. The heartbeat carries the node store's spill stats
and the spilled/restored events the head's directory marks.

Not ported: the chaos sites of the agent and the flight recorder (ROADMAP
10c), the head's dashboard and client server (item 12).
"""

from __future__ import annotations

import json
import math
import os
import signal
import socket
import sys
import threading

from ray_tpu_torch._private.rpc import (
    MuxRpcClient,
    RpcError,
    RpcMethodError,
    call_with_retry,
)

SESSION_DIR_ENV = "RAY_TPU_TORCH_SESSION_DIR"


def _session_dir() -> str:
    import tempfile

    return os.environ.get(SESSION_DIR_ENV) or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch")


def own_address() -> str:
    try:
        return socket.gethostbyname(socket.gethostname())
    except OSError:
        return "127.0.0.1"


def daemon_child_env(extra: dict | None = None) -> dict:
    """The environment of a daemon subprocess: this checkout resolves on
    ``PYTHONPATH`` even where the package is not installed."""
    env = dict(os.environ)
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    prior = env.get("PYTHONPATH", "")
    if pkg_root not in prior.split(os.pathsep):
        env["PYTHONPATH"] = pkg_root + (os.pathsep + prior if prior else "")
    env.update({k: str(v) for k, v in (extra or {}).items()})
    return env


class NodeAgent:
    """Registers a node with the head and heartbeats.

    A heartbeat carries the node's availability (``usage_fn``) and its
    executor stats (``stats_fn``); ``poke()`` sends one at once when the
    node's load changes, so the head's resource view follows the load
    and not the heartbeat period. A heartbeat the head refuses (it
    declared the node dead, or never knew it) makes the agent register
    again, asking to keep its id.

    ``gcs_epoch`` is the head epoch the agent registered under and stamps
    on its heartbeats; a reply showing another epoch (the head
    restarted) or a ``StaleEpochError`` makes it register again first.
    Against a head without fencing it stays None."""

    def __init__(self, gcs_address: str, resources: dict,
                 labels: dict | None = None,
                 heartbeat_period_s: float = 1.0, usage_fn=None,
                 executor_address: str = "", coalesce_s: float = 0.05,
                 stats_fn=None):
        self.client = MuxRpcClient(gcs_address, timeout_s=30.0)
        self.resources = dict(resources)
        self.labels = dict(labels or {})
        self.heartbeat_period_s = heartbeat_period_s
        # The least time between two pushes: a burst of admissions
        # becomes one heartbeat.
        self.coalesce_s = coalesce_s
        self.usage_fn = usage_fn
        self.stats_fn = stats_fn
        self.executor_address = executor_address
        self._address = f"{own_address()}:{os.getpid()}"
        self.node_id: bytes = b""
        self.gcs_epoch: "int | None" = None
        self._seen_epoch: "int | None" = None
        self._epoch_stale = threading.Event()
        self._poke = threading.Event()
        # The spill events of heartbeats that failed or were refused:
        # they ride the next one, so no mark in the head's directory is
        # lost with a beat.
        self._undelivered_events: list = []
        self.client.on_reply_meta = self._on_reply_meta
        self.node_id = self._register()
        self._shutdown = threading.Event()
        self._thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="ray_tpu_torch-node-heartbeat")
        self._thread.start()

    def _register(self) -> bytes:
        # Idempotent under prior_id (the head grants the same id to a
        # retried request), so it takes the retry policy.
        from ray_tpu_torch._private.same_host import host_identity

        node_id = call_with_retry(
            self.client.call, "register_node", self._address,
            self.resources, self.labels, self.executor_address,
            prior_id=self.node_id or None, host_id=host_identity())
        # The reply's meta carried the head's epoch: registering is the
        # re-sync, and the heartbeats stamp it from now on.
        self.gcs_epoch = self._seen_epoch
        self._epoch_stale.clear()
        return node_id

    def _on_reply_meta(self, meta: dict) -> None:
        """On the reader thread: an epoch other than the one registered
        under means the head restarted; wake the loop to register."""
        epoch = meta.get("epoch") if isinstance(meta, dict) else None
        if not isinstance(epoch, int):
            return
        self._seen_epoch = epoch
        if self.gcs_epoch is not None and epoch != self.gcs_epoch:
            self._epoch_stale.set()
            self._poke.set()

    def poke(self) -> None:
        """The node's load changed: heartbeat now (coalesced)."""
        self._poke.set()

    def _heartbeat_loop(self) -> None:
        while not self._shutdown.is_set():
            self._poke.wait(self.heartbeat_period_s)
            self._poke.clear()
            if self._shutdown.is_set():
                return
            available = stats = None
            try:
                if self.usage_fn is not None:
                    available = self.usage_fn()
                if self.stats_fn is not None:
                    stats = self.stats_fn()
            except Exception:  # noqa: BLE001 — the piggyback is best-effort
                pass
            events = None
            if isinstance(stats, dict):
                events = self._undelivered_events + stats.get(
                    "spill_events", [])
                self._undelivered_events = []
                if events:
                    stats["spill_events"] = events
            accepted = False
            try:
                if self._epoch_stale.is_set():
                    self.node_id = self._register()
                accepted = call_with_retry(
                    self.client.call, "heartbeat", self.node_id, available,
                    stats, None, attempts=2,
                    timeout_s=max(3.0, self.heartbeat_period_s * 3),
                    epoch=self.gcs_epoch)
                if not accepted:
                    self.node_id = self._register()
            except RpcMethodError as exc:
                from ray_tpu_torch._private.gcs import StaleEpochError

                if isinstance(exc.cause, StaleEpochError):
                    # Cut off across a head restart: re-sync.
                    try:
                        self.node_id = self._register()
                    except (RpcError, RpcMethodError, OSError):
                        pass  # the head went again; the next beat retries
            except (RpcError, OSError):
                pass  # the head is unreachable (it may restart); keep trying
            if events and not accepted:
                # Marks are idempotent: sent again, in their order.
                self._undelivered_events = events[-4096:]
            # Pokes that land during the wait fold into the next push.
            self._shutdown.wait(self.coalesce_s)

    def stop(self, drain: bool = True) -> None:
        self._shutdown.set()
        self._poke.set()
        if drain:
            try:
                self.client.call("drain_node", self.node_id, timeout_s=5.0)
            except (RpcError, RpcMethodError, OSError):
                pass  # the head may be gone: draining is advisory
        self.client.close()


def default_resources() -> dict:
    from ray_tpu_torch._private import accelerators

    resources = {"CPU": float(os.cpu_count() or 1)}
    resources.update(accelerators.detect_resources())
    return resources


def _check_cards(resources: dict) -> None:
    """Refuse a ``GPU`` count the daemon cannot see."""
    from ray_tpu_torch._private import accelerators

    want = float(resources.get("GPU", 0.0))
    seen = float(accelerators.detect_resources().get("GPU", 0.0))
    if seen < math.ceil(want - 1e-9):
        raise SystemExit(
            f"node declares GPU={want} but sees {seen:g} CUDA card(s) "
            f"(CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES')!r}"
            f"); it does not run GPU work on the CPU")


def _stop_on_signal() -> threading.Event:
    """An event SIGTERM and SIGINT set, installed before a daemon starts
    anything, so a stop during its start-up still cleans up."""
    stop_event = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_event.set())
    signal.signal(signal.SIGINT, lambda *_: stop_event.set())
    return stop_event


def _serve_until(stop_event: threading.Event, cleanup,
                 parent_pid: int | None = None) -> None:
    """Serve until ``stop_event``, or until ``parent_pid`` (the process
    that started this daemon) is gone; then ``cleanup()``."""
    try:
        while not stop_event.wait(0.5):
            if parent_pid is not None and os.getppid() != parent_pid:
                break
    finally:
        cleanup()


def _start_executor_node(gcs_address: str, resources: dict,
                         pool_size: int | None, labels: dict,
                         heartbeat_period_s: float):
    from ray_tpu_torch._private.node_executor import NodeExecutorService

    executor = NodeExecutorService(pool_size=pool_size, resources=resources)
    executor.advertised_address = executor.address_for("127.0.0.1")
    executor.start()
    agent = NodeAgent(gcs_address, resources, labels=labels,
                      heartbeat_period_s=heartbeat_period_s,
                      usage_fn=executor.available_resources,
                      executor_address=executor.advertised_address,
                      stats_fn=executor.stats_for_sync)
    executor.set_load_listener(agent.poke)
    return executor, agent


def run_worker(gcs_address: str, resources: dict | None = None,
               pool_size: int | None = None, labels: dict | None = None,
               heartbeat_period_s: float = 1.0,
               parent_pid: int | None = None) -> None:
    """A worker-node daemon: its executor, registered and heartbeating.
    Blocks until SIGTERM, or until ``parent_pid`` exits."""
    from ray_tpu_torch._private.node_executor import NODE_TAG_ENV

    stop_event = _stop_on_signal()
    resources = {k: float(v) for k, v in
                 (resources or default_resources()).items()}
    _check_cards(resources)
    # Before the pool starts: its workers inherit the tag.
    os.environ[NODE_TAG_ENV] = os.urandom(6).hex()
    executor, agent = _start_executor_node(
        gcs_address, resources, pool_size,
        {"node_role": "worker", **(labels or {})}, heartbeat_period_s)

    def cleanup():
        agent.stop()
        executor.stop()

    _serve_until(stop_event, cleanup, parent_pid)


def run_head(port: int = 0, resources: dict | None = None,
             dashboard_port: int | None = None) -> None:
    """The head daemon: the control plane and an executor node of its
    own, its address written to ``<session dir>/head_address``. It
    persists to ``<session dir>/gcs_snapshot.pkl``: started again after a
    crash on the same session dir (and port) it restores its tables and
    mints the next epoch. A clean stop removes the snapshot and the WAL
    (they exist for crash recovery) and keeps the epoch file, so epochs
    only grow. Blocks until SIGTERM."""
    from ray_tpu_torch._private.gcs_server import GcsServer
    from ray_tpu_torch._private.node_executor import NODE_TAG_ENV

    if dashboard_port is not None:
        raise NotImplementedError(
            "the head's dashboard is not ported yet (ROADMAP item 12)")
    stop_event = _stop_on_signal()
    session_dir = _session_dir()
    os.makedirs(session_dir, exist_ok=True)
    snapshot_path = os.path.join(session_dir, "gcs_snapshot.pkl")
    server = GcsServer(host="127.0.0.1", port=port, log_dir=session_dir,
                       persist_path=snapshot_path).start()
    resources = {k: float(v) for k, v in
                 (resources or default_resources()).items()}
    _check_cards(resources)
    os.environ.setdefault(NODE_TAG_ENV, f"head-{os.urandom(4).hex()}")
    executor, agent = _start_executor_node(
        server.address, resources, None, {"node_role": "head"}, 1.0)
    with open(os.path.join(session_dir, "head_address"), "w") as f:
        f.write(server.address)

    def cleanup():
        agent.stop()
        executor.stop()
        server.stop()
        for suffix in ("", ".prev", ".wal", ".wal.prev"):
            try:
                os.unlink(snapshot_path + suffix)
            except OSError:
                pass  # that generation was never written

    _serve_until(stop_event, cleanup)


def main(argv: list[str]) -> None:
    role = argv[0]
    kwargs = json.loads(argv[1]) if len(argv) > 1 else {}
    if role == "head":
        run_head(**kwargs)
    elif role == "worker":
        run_worker(**kwargs)
    else:
        raise SystemExit(f"unknown node role: {role}")


if __name__ == "__main__":
    main(sys.argv[1:])
