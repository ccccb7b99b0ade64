"""The port's head channels against the JAX package's: the hub's fan-out
and buffering, its long poll, the pruning of silent subscribers, and
publish and subscribe across processes through a cluster's head.

The four cases of tests/test_gcs_pubsub.py, each once through
``ray_tpu`` and once through ``ray_tpu_torch``, returning plain records
that must be equal, and equal to what the reference case asserts.
Where the reference sleeps for the poller to block, these wait for the
poll to be parked in the hub; the pruning case still ages a subscriber
past its TTL, which is the state under test. The cluster case has a
time limit of its own.
"""

from __future__ import annotations

import importlib
import threading
import time

import ray_tpu
import ray_tpu_torch
from torch_cluster_sides import wait_until
from torch_time_limit import time_limit

PACKAGES = {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch}


def _pubsub(name: str):
    return importlib.import_module(f"{name}._private.gcs_pubsub")


def _both(scenario, *args) -> dict:
    records = {name: scenario(name, *args) for name in PACKAGES}
    assert records["ray_tpu"] == records["ray_tpu_torch"], records
    return records["ray_tpu_torch"]


def fanout_and_buffering(name) -> dict:
    hub = _pubsub(name).ChannelHub(max_buffer=3)
    hub.subscribe("s1", ["a", "b"])
    hub.subscribe("s2", ["a"])
    record = {"delivered": [hub.publish("a", {"x": 1}),
                            hub.publish("b", "only-s1"),
                            hub.publish("c", "nobody")],
              "s1": hub.poll("s1", 0), "s2": hub.poll("s2", 0)}
    # Over the buffer cap the oldest go.
    for i in range(5):
        hub.publish("a", i)
    record["capped"] = [m for _, m in hub.poll("s2", 0)]
    # An unknown subscriber polls None (it subscribes again).
    record["ghost"] = hub.poll("ghost", 0)
    record["unsubscribed"] = [hub.unsubscribe("s1"), hub.unsubscribe("s1")]
    return record


def test_channel_hub_fanout_and_buffering():
    assert _both(fanout_and_buffering) == {
        "delivered": [2, 1, 0], "s1": [("a", {"x": 1}), ("b", "only-s1")],
        "s2": [("a", {"x": 1})], "capped": [2, 3, 4], "ghost": None,
        "unsubscribed": [True, False]}


def long_poll(name) -> dict:
    hub = _pubsub(name).ChannelHub()
    hub.subscribe("s", ["tick"])
    got = {}

    def poller():
        got["events"] = hub.poll("s", timeout_s=10.0)

    thread = threading.Thread(target=poller)
    thread.start()
    # Parked: the poll took its turn (the subscriber's epoch moved).
    parked = wait_until(lambda: hub._subs["s"].get("epoch", 0) >= 1, 10)
    hub.publish("tick", 42)
    thread.join(timeout=5)
    return {"parked": parked, "events": got.get("events")}


def test_channel_hub_long_poll_blocks_until_publish():
    assert _both(long_poll) == {"parked": True, "events": [("tick", 42)]}


def prunes_stale(name) -> dict:
    hub = _pubsub(name).ChannelHub(subscriber_ttl_s=0.2)
    hub.subscribe("gone", ["a"])
    time.sleep(0.3)  # past the TTL: the state under test
    hub.publish("a", 1)  # a publish prunes
    return {"subscribers": hub.num_subscribers(),
            "poll": hub.poll("gone", 0)}


def test_channel_hub_prunes_stale_subscribers():
    assert _both(prunes_stale) == {"subscribers": 0, "poll": None}


def over_cluster_head(name, tmp_path) -> dict:
    pubsub = _pubsub(name)
    PACKAGES[name].shutdown()
    cluster = importlib.import_module(f"{name}.cluster_utils").Cluster(
        log_dir=str(tmp_path / name))
    sub = pub = None

    def node_event(kind: str) -> bool:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if any(ch == "nodes" and msg[0] == kind
                   for ch, msg in sub.poll(timeout_s=2.0)):
                return True
        return False

    try:
        sub = pubsub.GcsSubscriber(cluster.address, ["nodes", "user-chan"])
        node = cluster.add_node(num_cpus=1)
        alive = node_event("ALIVE")
        pub = pubsub.GcsPublisher(cluster.address)
        delivered = pub.publish("user-chan", {"hello": "world"})
        got = sub.poll(timeout_s=5.0)
        # A daemon's death arrives as a DEAD push.
        cluster.remove_node(node, allow_graceful=True)
        return {"alive": alive, "delivered": delivered,
                "user_message": ("user-chan", {"hello": "world"}) in got,
                "dead": node_event("DEAD")}
    finally:
        for client in (sub, pub):
            if client is not None:
                client.close()
        cluster.shutdown()


def test_pubsub_over_cluster_head(tmp_path):
    with time_limit(240):
        assert _both(over_cluster_head, tmp_path) == {
            "alive": True, "delivered": 1, "user_message": True,
            "dead": True}
