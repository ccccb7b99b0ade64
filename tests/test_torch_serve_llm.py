"""The serving engine as a Serve deployment, in both serve packages.

The JAX package's ``LLMEngineServer`` is deployed with ``ray_tpu.serve``
and the port's (``device="cpu"``) with ``ray_tpu_torch.serve``, on the
same weights of the float32 tiny Llama (the port's carried over with
``params_from_numpy``), one replica each. Requests go through the
handle, the router and the replica actor:

- 4 concurrent ragged greedy requests, unary and streamed: the two
  packages' tokens are identical;
- a request whose deadline dies while the replica's engine is stalled
  seals ``TaskTimeoutError`` at the same stage (``llm_queue``) in both;
- a request the KV pool can never hold comes back as the engine's
  ``CacheExhaustedError``, through the router, in both.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jax_serve
from ray_tpu.models import llama as jax_llama
from ray_tpu.serve.llm_engine import LLMEngineServer as JaxServer
from ray_tpu_torch import serve as torch_serve
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm_engine import LLMEngineServer

ENGINE = dict(max_batch_size=4, max_seq_len=64, block_size=8,
              prefill_chunk=8, seed=0)
PROMPTS = [[5, 9, 2, 7], [1], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
           list(range(1, 22))]
WAIT_S = 120.0


def _stallable(server_cls):
    """The server with a hook that wedges its engine's loop."""

    class Served(server_cls):
        def stall(self, gate: threading.Event) -> None:
            self._engine._prefill_tick = \
                lambda: gate.wait(WAIT_S) and False

        def unstall(self) -> None:
            del self._engine._prefill_tick

    return Served


@pytest.fixture(scope="module")
def packages():
    """Each package's runtime, serve module, server class and arguments."""
    jax_cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  dtype=jnp.float32)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    jax_params = jax_llama.init_params(jax_cfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    return {"ray_tpu": (ray_tpu, jax_serve, _stallable(JaxServer),
                        (jax_cfg, jax_params), ENGINE),
            "ray_tpu_torch": (ray_tpu_torch, torch_serve,
                              _stallable(LLMEngineServer), (cfg, params),
                              {**ENGINE, "device": "cpu"})}


def _both(packages, scenario, **engine) -> dict:
    records = {}
    for name, (rt, serve, server, args, kwargs) in packages.items():
        rt.shutdown()
        rt.init(num_cpus=8)
        try:
            app = serve.deployment(server).options(name="llm").bind(
                *args, **{**kwargs, **engine})
            handle = serve.run(app, name="llm_app")
            records[name] = scenario(rt, handle)
        finally:
            try:
                serve.shutdown()
            finally:
                rt.shutdown()
    return records


def _concurrently(fn, n: int) -> list:
    results = [None] * n
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait(WAIT_S)
        results[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)
    return results


def test_greedy_tokens_identical_unary_and_streamed(packages):
    def scenario(rt, handle):
        def request(i):
            return {"tokens": PROMPTS[i], "max_new_tokens": 8}

        unary = _concurrently(lambda i: handle.remote(request(i)).result(
            timeout_s=WAIT_S)["tokens"], len(PROMPTS))
        streamed = _concurrently(lambda i: list(handle.options(
            method_name="generate", stream=True).remote(request(i))),
            len(PROMPTS))
        return [unary, streamed]

    records = _both(packages, scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"]
    unary, streamed = records["ray_tpu_torch"]
    assert streamed == unary and [len(t) for t in unary] == [8] * 4


def test_deadline_dead_in_a_stalled_engine_seals_the_same_stage(packages):
    def scenario(rt, handle):
        gate = threading.Event()
        handle.stall.remote(gate).result(timeout_s=WAIT_S)
        try:
            handle.options(deadline_s=0.5).remote(
                {"tokens": [1, 2, 3], "max_new_tokens": 4}).result(
                timeout_s=WAIT_S)
        except rt.exceptions.TaskTimeoutError as exc:
            return [type(exc).__name__, exc.stage]
        finally:
            gate.set()
        return None

    records = _both(packages, scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        ["TaskTimeoutError", "llm_queue"]


def test_cache_exhausted_comes_through_the_router_typed(packages):
    """2 usable blocks of 8 hold 16 tokens; the request needs 24."""
    def scenario(rt, handle):
        try:
            handle.remote({"tokens": list(range(12)),
                           "max_new_tokens": 12}).result(timeout_s=WAIT_S)
        except rt.exceptions.SystemOverloadedError as exc:
            return type(exc).__name__
        return None

    records = _both(packages, scenario, max_batch_size=1, num_blocks=3)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        "CacheExhaustedError"
