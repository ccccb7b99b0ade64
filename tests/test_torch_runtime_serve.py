"""The serving engine behind an actor of each runtime, with deadlines.

The JAX package's ``LLMEngineServer`` runs behind an actor of
``ray_tpu``, the port's (``device="cpu"``) behind an actor of
``ray_tpu_torch``, on the same numpy weights of the float32 tiny Llama.
An actor cannot be called through ``__call__`` (a handle refuses names
that begin with ``_``), so a small wrapper class forwards each request.

- 4 concurrent ragged greedy requests, each its own actor call: the two
  runtimes' tokens are identical.
- The call's deadline reaches the method through
  ``get_runtime_context().get_task_deadline()`` (the port of
  tests/test_llm_engine.py's test_actor_call_deadline_visible_in_context).
- A call whose budget is dead before the actor reaches it, and a call to
  an engine whose loop is stalled, seal ``TaskTimeoutError`` at the same
  stage in both runtimes.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.models import llama as jax_llama
from ray_tpu.serve.llm_engine import LLMEngineServer as JaxServer
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm_engine import LLMEngineServer

ENGINE = dict(max_batch_size=4, max_seq_len=64, block_size=8,
              prefill_chunk=8, seed=0)
PROMPTS = [[5, 9, 2, 7], [1], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
           list(range(1, 22))]
WAIT_S = 120.0


class Serving:
    """The actor: one engine server, a request per call."""

    def __init__(self, server_cls, *args, **kwargs):
        self.server = server_cls(*args, **kwargs)

    def generate(self, request: dict) -> dict:
        return self.server(request)

    def deadline(self):
        return self.rt.get_runtime_context().get_task_deadline()

    def stall(self, gate: threading.Event) -> None:
        """Wedge the engine loop at its next iteration until ``gate``."""
        self.server._engine._prefill_tick = \
            lambda: gate.wait(WAIT_S) and False

    def shutdown(self) -> None:
        self.server._engine.shutdown()


@pytest.fixture(scope="module")
def servers():
    """Each runtime's module and the arguments of its server."""
    jax_cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  dtype=jnp.float32)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    jax_params = jax_llama.init_params(jax_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    return {"ray_tpu": (ray_tpu, (JaxServer, jax_cfg, jax_params), ENGINE),
            "ray_tpu_torch": (ray_tpu_torch, (LLMEngineServer, cfg, params),
                              {**ENGINE, "device": "cpu"})}


def _serve(servers, name, scenario):
    rt, args, kwargs = servers[name]
    rt.shutdown()
    rt.init(num_cpus=8)
    try:
        cls = type("Serving", (Serving,), {"rt": rt})
        actor = rt.remote(max_concurrency=4)(cls).remote(*args, **kwargs)
        try:
            return scenario(rt, actor)
        finally:
            rt.get(actor.shutdown.remote(), timeout=WAIT_S)
            rt.kill(actor)
    finally:
        rt.shutdown()


def _both(servers, scenario) -> dict:
    return {name: _serve(servers, name, scenario) for name in servers}


def test_concurrent_ragged_greedy_identical_across_runtimes(servers):
    def scenario(rt, actor):
        refs = [actor.generate.remote({"tokens": p, "max_new_tokens": 8})
                for p in PROMPTS]
        return [out["tokens"] for out in rt.get(refs, timeout=WAIT_S)]

    records = _both(servers, scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"]
    assert [len(t) for t in records["ray_tpu_torch"]] == [8] * 4


def test_actor_call_deadline_visible_in_context(servers):
    def scenario(rt, actor):
        unarmed = rt.get(actor.deadline.remote(), timeout=WAIT_S)
        armed = rt.get(actor.deadline.options(_deadline_s=30.0).remote(),
                       timeout=WAIT_S)
        return [unarmed, armed is not None and armed > time.time() + 10]

    records = _both(servers, scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == [None, True]


def _timeout_record(rt, ref) -> list:
    """[class name, cause class name, stage] of the sealed timeout."""
    try:
        rt.get(ref, timeout=WAIT_S)
    except rt.exceptions.TaskError as exc:
        timeout = exc if isinstance(exc, rt.exceptions.TaskTimeoutError) \
            else exc.cause
        return [type(exc).__name__, type(exc.cause).__name__,
                getattr(timeout, "stage", None)]
    return []


def test_dead_deadline_seals_the_same_stage(servers):
    def scenario(rt, actor):
        ref = actor.generate.options(_deadline_s=-1.0).remote(
            {"tokens": [1, 2, 3], "max_new_tokens": 4})
        return _timeout_record(rt, ref)

    records = _both(servers, scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        ["TaskTimeoutError", "TimeoutError", "actor_queue"]


def test_stalled_engine_seals_the_inherited_deadline(servers):
    """The call runs, its request inherits the call's budget, and the
    engine's caller-side check seals it while the stalled loop never
    admits it."""
    def scenario(rt, actor):
        gate = threading.Event()
        rt.get(actor.stall.remote(gate), timeout=WAIT_S)
        try:
            ref = actor.generate.options(_deadline_s=0.5).remote(
                {"tokens": [1, 2, 3], "max_new_tokens": 4})
            return _timeout_record(rt, ref)
        finally:
            gate.set()

    records = _both(servers, scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        ["ActorError", "TaskTimeoutError", "llm_queue"]
