"""``LLMEngineServer``: the serve deployment class hosting one paged engine.

The port of ``ray_tpu/serve/llm_engine/server.py``. Request (token-in,
token-out, no tokenizer)::

    {"tokens": [int], "max_new_tokens": int, "temperature": float,
     "deadline_s": float (optional)}
      -> {"tokens": [int]}               (__call__, unary)
    generate(request)  -> yields int tokens as the engine emits them

``deadline_s`` is the request's budget from now; without it the request
inherits the deadline of the runtime call that carries it (an actor call
made with ``.options(_deadline_s=...)``). The engine refuses dead work
typed (``TaskTimeoutError`` with stage ``llm_queue`` or ``llm_decode``).
A full waiting queue or a request that never fits sheds
``CacheExhaustedError``, a ``SystemOverloadedError``. The reference's
legacy slot-server fallback is not ported yet.
"""

from __future__ import annotations

import time

from ray_tpu_torch.runtime_context import get_runtime_context
from ray_tpu_torch.serve.llm_engine.engine import LLMEngine


class LLMEngineServer:
    """Deployment class over one :class:`LLMEngine` on ``device`` (``None``
    is the current CUDA device and raises without a card)."""

    def __init__(self, config=None, params: "dict | None" = None, *,
                 max_batch_size: int = 8,
                 max_seq_len: "int | None" = None,
                 block_size: "int | None" = None,
                 num_blocks: "int | None" = None,
                 prefill_chunk: "int | None" = None,
                 max_waiting: "int | None" = None,
                 seed: int = 0, device=None):
        self._engine = LLMEngine(
            config, params, max_batch_size=max_batch_size,
            max_seq_len=max_seq_len, block_size=block_size,
            num_blocks=num_blocks, prefill_chunk=prefill_chunk,
            max_waiting=max_waiting, seed=seed, device=device)

    # ------------------------------------------------------------ data path

    @staticmethod
    def _deadline(request: dict) -> "float | None":
        """The request's own budget wins; else the runtime call's."""
        deadline_s = request.get("deadline_s")
        if deadline_s is not None:
            return time.time() + float(deadline_s)
        return get_runtime_context().get_task_deadline()

    def _submit(self, request: dict, stream: bool):
        return self._engine.submit(
            list(request.get("tokens") or []),
            max_new_tokens=int(request.get("max_new_tokens", 16)),
            temperature=float(request.get("temperature", 0.0)),
            deadline=self._deadline(request), stream=stream)

    def __call__(self, request: dict) -> dict:
        req = self._submit(request, stream=False)
        return {"tokens": self._engine.result(req, timeout_s=120.0)}

    def generate(self, request: dict):
        """Streaming generation: tokens are yielded as decode steps emit
        them."""
        yield from self._engine.stream_tokens(self._submit(request, True))

    # --------------------------------------------------------- control path

    def engine_stats(self) -> dict:
        """``ENGINE_STAT_KEYS`` counters, plus ``paged_engine`` (always
        True here: the port has only the paged engine)."""
        return {"paged_engine": True, **self._engine.engine_stats()}

    def serve_metrics(self) -> dict:
        """Live load gauges (the engine-depth signal of the latency
        autoscaler)."""
        load = self._engine.engine_load()
        return {"engine_depth": load["depth"],
                "engine_free_blocks": load["free_blocks"]}

    def check_health(self) -> None:
        self._engine.check_health()

    def shutdown(self) -> None:
        self._engine.shutdown()

    def __del__(self):
        """Stop the engine as ``shutdown()`` does, letting go of its KV
        pool and weights: a serve replica runs this when it is stopped."""
        engine = getattr(self, "_engine", None)
        if engine is not None:
            engine.shutdown()
