"""The Serve controller actor: reconciles deployments toward their target.

The port of ``ray_tpu/serve/controller.py``. The controller holds each
deployment's target (its config and replica count); a reconcile loop
starts and stops replica actors toward it, health checks replace a
replica that fails or hangs, and the autoscaler moves the target from
the replicas' queue depth or, with ``target_p99_s``, from the latency
the routers push (``LatencyPolicy``). Membership goes to the routers by
long poll.

Where the port differs: a replica whose constructor fails marks its
deployment ``DEPLOY_FAILED`` with that error, and no replica is started
again until the next deploy (``serve.run`` raises it); the reference
replaces it on every health check. ``shutdown()`` returns once every
replica has been drained and killed, so their resources (a ``GPU``) are
back and the deployments' arguments (weights) are let go of.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any

import ray_tpu_torch
from ray_tpu_torch.serve.config import DeploymentConfig, ReplicaConfig
from ray_tpu_torch.serve.long_poll import LongPollHost
from ray_tpu_torch.serve.replica import CONTROL_CONCURRENCY, Replica

logger = logging.getLogger("ray_tpu_torch")

RECONCILE_PERIOD_S = 0.05
# How long shutdown() waits for each replica's stop: its graceful drain
# (5 s by default) and its kill (which waits up to 10 s for running calls).
_STOP_WAIT_S = 60.0


def replica_actor_class(ray_actor_options: dict | None):
    """The replica actor class with the deployment's actor options, 16
    threads unless they say otherwise, and the control group (a process
    replica runs its calls on that many threads of its process). Raises
    ValueError for options no actor takes."""
    opts = dict(ray_actor_options or {})
    opts.setdefault("max_concurrency", 16)
    opts["concurrency_groups"] = {**CONTROL_CONCURRENCY,
                                  **opts.get("concurrency_groups", {})}
    return ray_tpu_torch.remote(Replica).options(**opts)


@dataclass
class _ReplicaState:
    tag: str
    handle: Any
    healthy: bool = True
    # Its constructor returned.
    ready: bool = False
    # In-flight health probe: (ref, sent_at monotonic). A probe
    # unanswered past health_check_timeout_s marks the replica dead.
    probe: tuple | None = None


@dataclass
class _DeploymentState:
    app_name: str
    name: str
    deployment_config: DeploymentConfig
    replica_config: ReplicaConfig
    target_replicas: int = 1
    replicas: list[_ReplicaState] = field(default_factory=list)
    handle_args: dict = field(default_factory=dict)
    last_scale_change: float = 0.0
    deleting: bool = False
    # A replica's constructor raised this: no replica starts again until
    # the next deploy.
    failure: BaseException | None = None
    # Latency-driven autoscaling (AutoscalingConfig.target_p99_s > 0):
    # the freshest router-pushed latency summary and when it came, and
    # the deployment's LatencyPolicy (its cooldown state).
    latency_report: dict | None = None
    latency_report_ts: float = 0.0
    latency_policy: Any = None


class ServeController:
    """Runs as a named actor; its methods are the control-plane API."""

    def __init__(self):
        self._lock = threading.RLock()
        self._deployments: dict[tuple[str, str], _DeploymentState] = {}
        self._ingress: dict[str, str] = {}
        self._long_poll = LongPollHost()
        self._replica_counter = itertools.count()
        self._stoppers: list[threading.Thread] = []
        self._shutdown = threading.Event()
        self._loop_thread = threading.Thread(
            target=self._reconcile_loop, name="serve-controller", daemon=True)
        self._loop_thread.start()

    # -------------------------------------------------------------- deploy

    def deploy(self, app_name: str, name: str,
               deployment_config: DeploymentConfig,
               replica_config: ReplicaConfig,
               handle_args: dict | None = None) -> None:
        with self._lock:
            key = (app_name, name)
            state = self._deployments.get(key)
            if state is None:
                state = _DeploymentState(
                    app_name=app_name, name=name,
                    deployment_config=deployment_config,
                    replica_config=replica_config,
                    handle_args=handle_args or {})
                self._deployments[key] = state
            else:
                state.deployment_config = deployment_config
                state.replica_config = replica_config
                state.handle_args = handle_args or {}
                state.deleting = False
                state.failure = None
                # A new user_config reconfigures the live replicas in
                # place.
                if deployment_config.user_config is not None:
                    for replica in state.replicas:
                        replica.handle.reconfigure.remote(
                            deployment_config.user_config)
            state.target_replicas = deployment_config.target_num_replicas

    def get_max_queued(self, app_name: str, name: str) -> int:
        """The router's shedding limit for one deployment
        (DeploymentConfig.max_queued_requests; -1 = unlimited)."""
        with self._lock:
            state = self._deployments.get((app_name, name))
            if state is None:
                return -1
            return int(state.deployment_config.max_queued_requests)

    def report_latency(self, app_name: str, name: str,
                       stats: dict) -> None:
        """A router's push: the deployment's latency summary
        (count/mean/p50_s/p99_s) for the latency autoscaler. The last
        writer wins: the policy needs a fresh view, not a merged one."""
        with self._lock:
            state = self._deployments.get((app_name, name))
            if state is not None:
                state.latency_report = dict(stats or {})
                state.latency_report_ts = time.monotonic()

    def get_latency_report(self, app_name: str, name: str) -> dict:
        """The freshest pushed report and its age."""
        with self._lock:
            state = self._deployments.get((app_name, name))
            if state is None or state.latency_report is None:
                return {}
            return {**state.latency_report,
                    "age_s": time.monotonic() - state.latency_report_ts}

    def set_ingress(self, app_name: str, deployment_name: str) -> None:
        with self._lock:
            self._ingress[app_name] = deployment_name

    def get_ingress(self, app_name: str) -> str | None:
        with self._lock:
            return self._ingress.get(app_name)

    def delete_app(self, app_name: str) -> None:
        with self._lock:
            self._ingress.pop(app_name, None)
            for key, state in self._deployments.items():
                if key[0] == app_name:
                    state.deleting = True
                    state.target_replicas = 0

    def shutdown(self) -> None:
        """Stop every replica and wait for each to be drained and killed;
        then the controller holds no deployment."""
        with self._lock:
            self._ingress.clear()
            for state in self._deployments.values():
                state.deleting = True
                state.target_replicas = 0
        self._shutdown.set()
        self._loop_thread.join(timeout=10.0)
        self._reconcile_once()
        with self._lock:
            stoppers, self._stoppers = self._stoppers, []
            self._deployments.clear()
        for thread in stoppers:
            thread.join(timeout=_STOP_WAIT_S)
        self._long_poll.close()

    # -------------------------------------------------------------- queries

    def listen_for_change(self, keys_to_versions: dict):
        return self._long_poll.listen_for_change(keys_to_versions)

    def get_status(self) -> dict:
        with self._lock:
            return {
                f"{app}::{name}": {
                    "target_replicas": st.target_replicas,
                    "running_replicas": len(st.replicas),
                    "ready_replicas": sum(r.ready for r in st.replicas),
                    "replica_tags": [r.tag for r in st.replicas],
                    "status": "DEPLOY_FAILED" if st.failure is not None
                    else "HEALTHY" if len(st.replicas) == sum(
                        r.ready for r in st.replicas) == st.target_replicas
                    else "UPDATING",
                }
                for (app, name), st in self._deployments.items()
                if not st.deleting
            }

    def get_deploy_failure(self, app_name: str) -> BaseException | None:
        """The error a replica constructor of ``app_name`` raised, if
        one did since its deploy."""
        with self._lock:
            for (app, _), state in self._deployments.items():
                if app == app_name and state.failure is not None:
                    return state.failure
            return None

    def list_deployments(self) -> list[tuple[str, str]]:
        with self._lock:
            return [key for key, st in self._deployments.items()
                    if not st.deleting]

    # ------------------------------------------------------------ reconcile

    def _start_replica(self, state: _DeploymentState) -> None:
        tag = f"{state.name}#{next(self._replica_counter)}"
        cfg = state.deployment_config
        handle = replica_actor_class(
            state.replica_config.ray_actor_options).remote(
            state.name, tag,
            state.replica_config.deployment_def,
            state.replica_config.init_args,
            state.replica_config.init_kwargs,
            user_config=cfg.user_config,
            max_ongoing_requests=cfg.max_ongoing_requests,
            handle_args=state.handle_args,
        )
        state.replicas.append(_ReplicaState(tag=tag, handle=handle))

    def _stop_replica(self, replica: _ReplicaState,
                      graceful_timeout_s: float = 5.0) -> None:
        def drain_then_kill():
            try:
                ray_tpu_torch.get(replica.handle.prepare_for_shutdown.remote(),
                                  timeout=graceful_timeout_s)
            except Exception:  # noqa: BLE001 — the kill below ends it anyway
                logger.exception("replica %s did not drain", replica.tag)
            ray_tpu_torch.kill(replica.handle, no_restart=True)

        # Off the reconcile thread: a graceful drain must not stall the
        # reconciliation of other deployments.
        thread = threading.Thread(target=drain_then_kill, daemon=True,
                                  name=f"stop-{replica.tag}")
        with self._lock:
            self._stoppers = [t for t in self._stoppers if t.is_alive()]
            self._stoppers.append(thread)
        thread.start()

    def _broadcast(self, state: _DeploymentState) -> None:
        key = f"replicas::{state.app_name}::{state.name}"
        self._long_poll.notify_changed(
            key, [r.handle for r in state.replicas if r.healthy])

    def _reconcile_once(self) -> None:
        with self._lock:
            states = list(self._deployments.items())
        for key, state in states:
            with self._lock:
                changed = False
                while state.failure is None \
                        and len(state.replicas) < state.target_replicas:
                    self._start_replica(state)
                    changed = True
                while len(state.replicas) > state.target_replicas:
                    self._stop_replica(
                        state.replicas.pop(),
                        state.deployment_config.graceful_shutdown_timeout_s)
                    changed = True
                if changed:
                    state.last_scale_change = time.monotonic()
                    self._broadcast(state)
                if state.deleting and not state.replicas:
                    del self._deployments[key]

    def _check_started_once(self) -> None:
        """A replica whose constructor returned is ready; one whose
        constructor raised fails its deployment."""
        with self._lock:
            states = list(self._deployments.values())
        for state in states:
            with self._lock:
                starting = [r for r in state.replicas if not r.ready]
            for replica in starting:
                created = replica.handle._creation_ref
                if not ray_tpu_torch.wait([created], timeout=0)[0]:
                    continue
                try:
                    ray_tpu_torch.get(created)
                except Exception as exc:  # noqa: BLE001 — kept as the deployment's failure
                    with self._lock:
                        state.failure = exc
                        if replica in state.replicas:
                            state.replicas.remove(replica)
                            self._broadcast(state)
                    continue
                replica.ready = True

    def _autoscale_once(self) -> None:
        with self._lock:
            states = [st for st in self._deployments.values()
                      if st.deployment_config.autoscaling_config is not None
                      and not st.deleting]
        for state in states:
            cfg = state.deployment_config.autoscaling_config
            with self._lock:
                replicas = list(state.replicas)
            refs = [replica.handle.get_metrics.remote()
                    for replica in replicas]
            total_ongoing = 0.0
            engine_depth = 0.0
            for ref in refs:
                try:
                    metrics = ray_tpu_torch.get(ref, timeout=1.0)
                except Exception:  # noqa: BLE001 — a dead or busy replica reports nothing
                    continue
                total_ongoing += metrics["num_ongoing_requests"]
                # An engine-hosting replica also reports the requests
                # parked in its engine's queue: load its ongoing count
                # does not show.
                engine_depth += float(metrics.get("engine_depth", 0) or 0)
            current = len(replicas)
            now = time.monotonic()
            if cfg.target_p99_s > 0:
                desired = self._latency_desired(
                    state, cfg, current, total_ongoing + engine_depth, now)
                if desired is not None and desired != current:
                    with self._lock:
                        state.target_replicas = desired
                continue
            desired = cfg.desired_replicas(
                total_ongoing + engine_depth, current)
            delay = (cfg.upscale_delay_s if desired > current
                     else cfg.downscale_delay_s)
            if desired != current and \
                    now - state.last_scale_change >= delay:
                with self._lock:
                    state.target_replicas = desired

    def _latency_desired(self, state: _DeploymentState, cfg,
                         current: int, depth: float,
                         now: float) -> "int | None":
        """The latency loop: LatencyPolicy over the freshest pushed p99
        and the replicas' and engines' depth."""
        from ray_tpu_torch.serve.llm_engine.autoscale import LatencyPolicy

        with self._lock:
            if state.latency_policy is None:
                state.latency_policy = LatencyPolicy(cfg)
            policy = state.latency_policy
            report = state.latency_report
            age_s = (now - state.latency_report_ts
                     if report is not None else float("inf"))
        if report is None or current == 0:
            return None
        return policy.desired(current, float(report.get("p99_s", 0.0)),
                              depth, now, feed_age_s=age_s)

    def _health_check_once(self) -> None:
        """A non-blocking probe cycle over the ready replicas: each has at
        most one check_health in flight; a probe that raises, or one
        unanswered past health_check_timeout_s, marks the replica dead,
        and the next reconcile replaces it."""
        with self._lock:
            states = list(self._deployments.values())
        now = time.monotonic()
        for state in states:
            timeout_s = state.deployment_config.health_check_timeout_s
            dead = []
            with self._lock:
                replicas = [r for r in state.replicas if r.ready]
            for replica in replicas:
                if replica.probe is None:
                    replica.probe = (replica.handle.check_health.remote(), now)
                    continue
                ref, sent_at = replica.probe
                if ray_tpu_torch.wait([ref], timeout=0)[0]:
                    try:
                        ray_tpu_torch.get(ref)
                        replica.probe = None  # healthy; probed again next
                    except Exception:  # noqa: BLE001 — the probe raised: replaced
                        dead.append(replica)
                elif now - sent_at > timeout_s:
                    dead.append(replica)  # hung past the deadline
            if dead:
                with self._lock:
                    for replica in dead:
                        if replica in state.replicas:
                            state.replicas.remove(replica)
                            self._stop_replica(
                                replica, state.deployment_config
                                .graceful_shutdown_timeout_s)
                    self._broadcast(state)

    def _reconcile_loop(self) -> None:
        last_autoscale = 0.0
        last_health = 0.0
        while not self._shutdown.is_set():
            try:
                self._reconcile_once()
                self._check_started_once()
                now = time.monotonic()
                if now - last_autoscale > 0.25:
                    self._autoscale_once()
                    last_autoscale = now
                with self._lock:
                    period = min(
                        (st.deployment_config.health_check_period_s
                         for st in self._deployments.values()),
                        default=2.0)
                if now - last_health > period:
                    self._health_check_once()
                    last_health = now
            except Exception:  # noqa: BLE001 — the loop must go on
                logger.exception("serve controller reconcile pass failed")
            self._shutdown.wait(RECONCILE_PERIOD_S)
