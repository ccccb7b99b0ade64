"""Cluster-wide pub/sub channels served by the head.

The port of ``ray_tpu/_private/gcs_pubsub.py``. The head fans each
message out to the buffers of the channel's subscribers, and a
subscriber drains its buffer with a long poll (``GcsSubscriber``); a
client publishes through ``GcsPublisher``:

    pubsub_subscribe(sub_id, channels)
    pubsub_poll(sub_id, timeout) -> [(channel, message), ...]
    pubsub_publish(channel, message) -> receiver count
    pubsub_unsubscribe(sub_id)

The head publishes node membership on ``nodes`` and the availability its
heartbeats carry on ``node_resources``; a driver's node watcher reacts to
both by push instead of polling the node table. A subscriber that stops
polling for a TTL is pruned, as its buffer would grow without bound.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any


class ChannelHub:
    """The head's side: channels and a buffer per subscriber."""

    def __init__(self, max_buffer: int = 1000,
                 subscriber_ttl_s: float = 60.0):
        self._cond = threading.Condition(threading.Lock())
        self._max_buffer = max_buffer
        self._ttl = subscriber_ttl_s
        # sub_id -> {"channels", "queue", "seen", "dropped", "epoch"}
        self._subs: dict[str, dict] = {}

    def subscribe(self, sub_id: str, channels: list[str]) -> None:
        with self._cond:
            self._prune_locked(time.monotonic())
            sub = self._subs.setdefault(sub_id, {
                "channels": set(), "queue": collections.deque(),
                "seen": time.monotonic(), "dropped": 0, "epoch": 0})
            sub["channels"].update(channels)
            sub["seen"] = time.monotonic()

    def _prune_locked(self, now: float) -> None:
        for sub_id in list(self._subs):
            if now - self._subs[sub_id]["seen"] > self._ttl:
                del self._subs[sub_id]

    def prune(self) -> None:
        """The head's periodic sweep of silent subscribers."""
        with self._cond:
            self._prune_locked(time.monotonic())

    def unsubscribe(self, sub_id: str) -> bool:
        with self._cond:
            return self._subs.pop(sub_id, None) is not None

    def publish(self, channel: str, message: Any) -> int:
        delivered = 0
        with self._cond:
            self._prune_locked(time.monotonic())
            for sub in self._subs.values():
                if channel not in sub["channels"]:
                    continue
                if len(sub["queue"]) >= self._max_buffer:
                    sub["queue"].popleft()  # the oldest goes, counted
                    sub["dropped"] += 1
                sub["queue"].append((channel, message))
                delivered += 1
            if delivered:
                self._cond.notify_all()
        return delivered

    def poll(self, sub_id: str, timeout_s: float = 10.0) -> list | None:
        """Drain the subscriber's buffer, waiting up to ``timeout_s`` for
        the first message. None: the subscriber is unknown (pruned) and
        must subscribe again. A newer poll of the same subscriber (the
        client re-polled after a dropped connection) supersedes this one,
        which returns without draining."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._cond:
            sub = self._subs.get(sub_id)
            if sub is None:
                return None
            sub["epoch"] += 1
            my_epoch = sub["epoch"]
            while True:
                sub = self._subs.get(sub_id)
                if sub is None:
                    return None
                if sub["epoch"] != my_epoch:
                    return []
                sub["seen"] = time.monotonic()
                if sub["queue"]:
                    out = list(sub["queue"])
                    sub["queue"].clear()
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._cond.wait(min(remaining, 1.0))

    def num_subscribers(self) -> int:
        with self._cond:
            return len(self._subs)


class GcsSubscriber:
    """The subscriber's side: subscribe once, then poll in a loop; it
    subscribes again if the head pruned it."""

    # A long poll must end well inside the client's socket timeout.
    _MAX_POLL_S = 25.0

    def __init__(self, address: str, channels: list[str]):
        from ray_tpu_torch._private.rpc import RpcClient

        self._client = RpcClient(address, timeout_s=30.0)
        self._channels = list(channels)
        self.sub_id = os.urandom(8).hex()
        try:
            self._client.call("pubsub_subscribe", self.sub_id,
                              self._channels)
        except BaseException:
            self._client.close()
            raise

    def poll(self, timeout_s: float = 10.0) -> list:
        """The buffered messages. After the head pruned this subscriber
        they start with ``("resubscribed", None)``: what was published
        in between is lost, and the caller reads the state again."""
        events = self._client.call("pubsub_poll", self.sub_id,
                                   min(timeout_s, self._MAX_POLL_S))
        if events is None:
            self._client.call("pubsub_subscribe", self.sub_id,
                              self._channels)
            events = [("resubscribed", None)] + (self._client.call(
                "pubsub_poll", self.sub_id, 0.0) or [])
        return events or []

    def close(self) -> None:
        # No goodbye call: with the head gone it would block a socket
        # timeout; the hub prunes silent subscribers.
        self._client.close()


class GcsPublisher:
    """The publisher's side: one connection to the head."""

    def __init__(self, address: str):
        from ray_tpu_torch._private.rpc import RpcClient

        self._client = RpcClient(address, timeout_s=10.0)

    def publish(self, channel: str, message: Any) -> int:
        """The number of subscribers the message reached."""
        return self._client.call("pubsub_publish", channel, message)

    def close(self) -> None:
        self._client.close()
