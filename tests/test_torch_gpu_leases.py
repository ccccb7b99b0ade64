"""A ``GPU`` lease names its cards (port only: the reference's ``TPU``
leases name no chips).

The node's ``GPU`` hands out card indices with each whole-unit lease; a
fractional lease takes a share of the card a co-tenant sits on where it
has room. An in-thread task or actor runs on its lease's first card
(``torch.cuda.set_device`` on its thread, when the card exists); a
process actor sees exactly its cards in ``CUDA_VISIBLE_DEVICES``, and
one without a ``GPU`` lease sees none. Held on the CPU with
``RAY_TPU_TORCH_NUM_GPUS=2`` standing for a host of two cards.
"""

import os

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._private import serialization
from ray_tpu_torch.util.placement_group import placement_group
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
)

WAIT_S = 60.0


@pytest.fixture
def two_cards(monkeypatch):
    monkeypatch.setenv("RAY_TPU_TORCH_NUM_GPUS", "2")
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
class _Env:
    def visible(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def gpu_ids(self):
        return ray_tpu_torch.get_runtime_context().get_gpu_ids()


def test_process_actors_see_the_cards_they_leased(two_cards):
    rt = two_cards
    gpu_actor = _Env.options(process=True, num_gpus=1)
    first, second = gpu_actor.remote(), gpu_actor.remote()
    seen = sorted(rt.get([a.visible.remote() for a in (first, second)],
                         timeout=WAIT_S))
    assert seen == ["0", "1"]
    assert rt.available_resources().get("GPU", 0.0) == 0.0
    third = gpu_actor.remote()
    ready, _ = rt.wait([third.visible.remote()], timeout=1.0)
    assert ready == []  # it waits for a card
    cpu_only = _Env.options(process=True).remote()
    assert rt.get(cpu_only.visible.remote(), timeout=WAIT_S) == ""
    freed = rt.get(first.visible.remote(), timeout=WAIT_S)
    rt.kill(first)
    assert rt.get(third.visible.remote(), timeout=WAIT_S) == freed
    for actor in (second, third, cpu_only):
        rt.kill(actor)
    assert rt.available_resources()["GPU"] == 2.0


def test_in_thread_leases_set_their_card(two_cards, monkeypatch):
    """Each thread that runs a ``GPU`` lease's work makes the lease's
    first card current; fractional leases share a co-tenant's card."""
    rt = two_cards
    set_on = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", set_on.append)
    whole = [_Env.options(num_gpus=1).remote() for _ in range(2)]
    assert sorted(rt.get([a.gpu_ids.remote() for a in whole],
                         timeout=WAIT_S)) == [[0], [1]]
    for actor in whole:
        rt.kill(actor)
    halves = [_Env.options(num_gpus=0.5).remote() for _ in range(3)]
    ids = rt.get([a.gpu_ids.remote() for a in halves], timeout=WAIT_S)
    assert sorted(ids) == [[0], [0], [1]]
    for actor in halves:
        rt.kill(actor)

    @rt.remote(num_gpus=1)
    def task_ids():
        return rt.get_runtime_context().get_gpu_ids()

    assert rt.get(task_ids.remote(), timeout=WAIT_S) in ([0], [1])
    assert sorted(set(set_on)) == [0, 1]


def test_a_bundle_lends_its_own_card(two_cards):
    rt = two_cards
    blocker = _Env.options(num_gpus=1).remote()
    held = rt.get(blocker.gpu_ids.remote(), timeout=WAIT_S)
    pg = placement_group([{"CPU": 1, "GPU": 1}])
    assert pg.wait(timeout_seconds=WAIT_S)
    inside = _Env.options(num_gpus=0.5, scheduling_strategy=(
        PlacementGroupSchedulingStrategy(placement_group=pg))).remote()
    assert rt.get(inside.gpu_ids.remote(), timeout=WAIT_S) == [1 - held[0]]
    rt.kill(inside)
    rt.kill(blocker)


def test_a_gpu_process_actor_without_a_card_refuses_to_start(
        two_cards, monkeypatch):
    """Where the driver sees cards, a GPU process actor that finds none
    fails its constructor instead of running on the CPU."""
    rt = two_cards
    monkeypatch.setattr(serialization, "sees_card", lambda: True)
    actor = _Env.options(process=True, num_gpus=1).remote()
    with pytest.raises(rt.exceptions.ActorDiedError):
        rt.get(actor.visible.remote(), timeout=WAIT_S)
    with pytest.raises(rt.exceptions.ActorError, match="sees no CUDA card"):
        rt.get(actor._creation_ref, timeout=WAIT_S)
    assert rt.available_resources()["GPU"] == 2.0
