"""The continuous-batching engine loop over the paged KV cache.

The port of ``ray_tpu/serve/llm_engine/engine.py``. One thread per engine
runs the scheduler's interleave: sweep expired budgets, claim or advance
ONE prefill chunk, then ONE fixed-shape decode step for every active
stream. Tokens stream out per step, finished rows free their blocks
between steps, and cache pressure preempts the lowest-progress stream
(recompute-on-resume) instead of failing it.

Every device operation runs on the loop thread, on the current stream of
the engine's device; ``submit``, ``result`` and ``stream_tokens`` callers
only touch host state under the engine's lock. A step that raises (a
failed kernel launch, a device fault) lands in ``_reset_after_failure``,
which seals every in-flight request with the error and re-inits the pool.

The process-wide registry of live engines (``merged_engine_stats``,
``merged_engine_load``) is what a daemon hosting an engine ships on its
heartbeat (the ``engine`` group) and what ``/metrics`` serves as
``node_engine``. The reference's ``PAGED_ON`` gate (it picks the legacy
slot server) and its ``llm.slow_step`` chaos hook are not ported yet.
"""

from __future__ import annotations

import functools
import queue as queue_mod
import threading
import time
import weakref

import numpy as np
import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.exceptions import CacheExhaustedError, GetTimeoutError
from ray_tpu_torch.serve.llm_engine import model as paged_model
from ray_tpu_torch.serve.llm_engine.kv_cache import PagedKVCache
from ray_tpu_torch.serve.llm_engine.scheduler import (
    DECODE,
    EngineRequest,
    Scheduler,
)

__all__ = ["ENGINE_STAT_KEYS", "LLMEngine", "merged_engine_stats",
           "merged_engine_load"]

# Counter contract: code increments exactly these keys and
# engine_stats() serves them (the reference's keys; ``slow_steps`` stays 0
# until the chaos hook is ported).
ENGINE_STAT_KEYS = (
    "admitted", "shed_queue_full", "shed_cache",
    "prefill_chunks", "prefill_tokens",
    "decode_steps", "batched_decode_steps", "decode_tokens",
    "preemptions", "resumes", "finished", "deadline_expired",
    "slow_steps", "blocks_allocated", "blocks_freed",
)

# This process's live engines, for the stats of its heartbeat.
_LIVE: "weakref.WeakSet" = weakref.WeakSet()


class LLMEngine:
    """Paged-KV continuous-batching engine (token-in/token-out).

    ``device``: where the pool lives and every step runs; ``None`` is the
    current CUDA device and raises without a card. ``params`` must be on
    that device (``None`` draws them from ``seed``)."""

    def __init__(self, config=None, params=None, *,
                 max_batch_size: int = 8, max_seq_len: "int | None" = None,
                 block_size: "int | None" = None,
                 num_blocks: "int | None" = None,
                 prefill_chunk: "int | None" = None,
                 max_waiting: "int | None" = None,
                 seed: int = 0, device=None):
        from ray_tpu_torch._private.config import GLOBAL_CONFIG
        from ray_tpu_torch.models import llama

        self.device = resolve_device(device)
        self.config = config or llama.LlamaConfig.tiny()
        if params is None:
            params = llama.init_params(
                self.config, torch.Generator(self.device).manual_seed(seed),
                self.device)
        elif params["embed"]["tokens"].device != self.device:
            raise ValueError(
                f"params are on {params['embed']['tokens'].device}, the "
                f"engine's device is {self.device}")
        self.params = params
        self.max_batch = int(max_batch_size)
        self.max_len = int(max_seq_len or self.config.max_seq_len)
        self.block_size = int(block_size or GLOBAL_CONFIG.llm_block_size)
        self.prefill_chunk_len = int(
            prefill_chunk or GLOBAL_CONFIG.llm_prefill_chunk)
        # Table width: blocks covering max_len, rounded up; one decode
        # shape at [max_batch, M * block_size] attention width.
        self.blocks_per_seq = -(-self.max_len // self.block_size)
        self.max_tokens = self.blocks_per_seq * self.block_size
        if num_blocks is None:
            # Default pool: every row can hold a full-length sequence
            # (+ scratch). Smaller pools oversubscribe and lean on
            # preemption.
            num_blocks = 1 + self.max_batch * self.blocks_per_seq
        cache = PagedKVCache(int(num_blocks), self.block_size,
                             self.blocks_per_seq)
        self._sched = Scheduler(
            cache, self.max_batch,
            int(max_waiting or GLOBAL_CONFIG.llm_max_waiting),
            self.max_tokens)
        self._pool = PagedKVCache.init_pool(
            self.config, cache.num_blocks, self.block_size,
            device=self.device)
        self._generator = torch.Generator(self.device).manual_seed(seed + 1)
        self._counters: "dict[str, int]" = {k: 0 for k in ENGINE_STAT_KEYS}
        _LIVE.add(self)
        self._lock = threading.Condition()
        self._shutdown = threading.Event()
        self._loop_error: "BaseException | None" = None
        self._loop_thread = threading.Thread(
            target=self._engine_loop, name="llm-paged-engine", daemon=True)
        self._loop_thread.start()

    # ---------------------------------------------------------------- steps

    @functools.cached_property
    def _decode_step(self):
        return paged_model.make_decode_step(self.config, self.block_size)

    @functools.cached_property
    def _prefill_step(self):
        return paged_model.make_prefill_chunk(self.config, self.block_size)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(array).to(self.device)

    # ----------------------------------------------------------- public API

    def submit(self, tokens, max_new_tokens: int = 16,
               temperature: float = 0.0,
               deadline: "float | None" = None, stream: bool = False,
               name: str = "llm_generate") -> EngineRequest:
        """Admit one request (bounded: a full queue or a request that can
        never fit sheds typed, :class:`CacheExhaustedError`). ``deadline``
        is absolute (``time.time()``)."""
        max_new = max(1, min(int(max_new_tokens), self.max_tokens - 2))
        prompt = list(tokens) or [0]
        keep = max(1, self.max_tokens - max_new - 1)
        prompt = prompt[-keep:]
        req = EngineRequest(prompt, max_new, temperature,
                            deadline=deadline, name=name, stream=stream)
        with self._lock:
            if self._shutdown.is_set():
                raise RuntimeError("LLM engine is shut down")
            sched = self._sched
            if len(sched.waiting) >= sched.max_waiting:
                self._counters["shed_queue_full"] += 1
                raise CacheExhaustedError(
                    f"engine waiting queue full ({sched.max_waiting})")
            if not sched.cache.fits_ever(
                    min(len(prompt) + max_new, self.max_tokens)):
                self._counters["shed_cache"] += 1
                raise CacheExhaustedError(
                    f"request needs more KV blocks than the pool holds "
                    f"({sched.cache.usable_blocks})")
            sched.try_enqueue(req)
            self._counters["admitted"] += 1
            self._lock.notify_all()
        return req

    def result(self, req: EngineRequest,
               timeout_s: "float | None" = None) -> "list[int]":
        """Block until the request seals; a dead budget seals it typed
        here, exactly once, even when the engine loop is wedged."""
        wall_deadline = (time.monotonic() + timeout_s
                         if timeout_s is not None else None)
        while not req.done.wait(timeout=0.05):
            self._check_caller_deadline(req)
            if wall_deadline is not None \
                    and time.monotonic() > wall_deadline:
                raise GetTimeoutError(
                    f"generation exceeded timeout_s={timeout_s}")
        if req.error is not None:
            raise req.error
        return list(req.output)

    def stream_tokens(self, req: EngineRequest):
        """Yield tokens as the engine emits them. Ends with the sealed
        result: StopIteration on success, the typed error otherwise."""
        if req.stream is None:
            raise ValueError("submit(stream=True) first")
        while True:
            try:
                kind, payload = req.stream.get(timeout=0.05)
            except queue_mod.Empty:
                self._check_caller_deadline(req)
                continue
            if kind == "tok":
                yield payload
            elif kind == "end":
                return
            else:
                raise payload

    def _check_caller_deadline(self, req: EngineRequest) -> None:
        if req.deadline is not None and time.time() > req.deadline \
                and not req.sealed:
            if self._seal(req, self._sched.expired_error(req)):
                with self._lock:
                    self._counters["deadline_expired"] += 1

    # -------------------------------------------------------------- sealing

    def _seal(self, req: EngineRequest,
              error: "Exception | None" = None) -> bool:
        """The one commit point: the first sealer wins (engine finish,
        deadline sweep, caller-side deadline, shutdown, failure)."""
        with self._lock:
            if req.sealed:
                return False
            req.sealed = True
            req.error = error
        if req.stream is not None:
            req.stream.put(("err", error) if error is not None
                           else ("end", None))
        req.done.set()
        return True

    def _emit(self, req: EngineRequest, token: int) -> None:
        req.output.append(token)
        if req.stream is not None:
            req.stream.put(("tok", token))

    # --------------------------------------------------------------- engine

    def _engine_loop(self) -> None:
        try:
            self._run_loop()
        except BaseException as exc:
            # The loop cannot go on (e.g. the pool could not be rebuilt
            # after a device fault): refuse new work and fail every
            # in-flight request with the error instead of leaving it to
            # hang.
            self._loop_error = exc
            self._shutdown.set()
            with self._lock:
                victims = self._drain_locked()
            for req in victims:
                self._seal(req, exc)
            raise

    def _run_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._shutdown.is_set():
            with self._lock:
                newly_expired = self._sched.sweep_expired()
                for req in newly_expired:
                    self._counters["deadline_expired"] += 1
            for req in newly_expired:
                self._seal(req, self._sched.expired_error(req))
            progressed = self._prefill_tick()
            progressed = self._decode_tick() or progressed
            if not progressed:
                with self._lock:
                    if self._sched.depth() == 0:
                        self._lock.wait(0.002)

    def _grow_or_preempt_locked(self, req: EngineRequest,
                                n_tokens: int) -> str:
        """Grow ``req``'s table to cover ``n_tokens``, preempting the
        lowest-progress stream per retry (caller holds the lock). Returns
        ``"ok"``, ``"victim"`` when ``req`` itself was preempted, or
        ``"shed"`` when nothing was left to preempt (the caller seals
        typed, outside the lock)."""
        while True:
            try:
                self._sched.cache.grow(req.block_table, n_tokens)
                return "ok"
            except CacheExhaustedError:
                victim = self._sched.pick_victim()
                if victim is None and self._sched.prefilling is req:
                    # No decode stream left to preempt and the pool still
                    # can't take the prefill: shed typed (only while
                    # sealed-but-unswept holders pin blocks).
                    self._sched.prefilling = None
                    self._sched.cache.release(req.block_table)
                    self._counters["shed_cache"] += 1
                    return "shed"
                if victim is None:
                    victim = req
                self._counters["preemptions"] += 1
                self._sched.preempt(victim)
                if victim is req:
                    return "victim"

    def _prefill_tick(self) -> bool:
        """At most ONE chunk of ONE request per engine iteration: the
        interleave that keeps long prompts from stalling decode."""
        with self._lock:
            if self._sched.prefilling is None:
                claimed = self._sched.claim_prefill()
                if claimed is not None and claimed.preempted > 0:
                    self._counters["resumes"] += 1
            req = self._sched.prefilling
            if req is None:
                return False
            n = min(self.prefill_chunk_len,
                    len(req.context) - req.prefilled)
            status = self._grow_or_preempt_locked(req, req.prefilled + n)
            if status == "ok":
                start = req.prefilled
                table = list(req.block_table)
        if status == "shed":
            self._seal(req, CacheExhaustedError(
                "KV block pool exhausted mid-prefill"))
            return True
        if status == "victim":
            return True  # re-queued; pressure eased

        chunk = self.prefill_chunk_len
        tokens = np.zeros((1, chunk), dtype=np.int64)
        tokens[0, :n] = req.context[start:start + n]
        positions = np.zeros((1, chunk), dtype=np.int64)
        positions[0, :n] = np.arange(start, start + n)
        bt = np.zeros((1, self.blocks_per_seq), dtype=np.int64)
        bt[0, :len(table)] = table
        first_token = None
        try:
            last_logits, self._pool = self._prefill_step(
                self.params, self._pool, self._to_device(tokens),
                self._to_device(positions), self._to_device(bt), n, n - 1)
            if req.sample_first and start + n >= len(req.context):
                first_token = self._sample_first(req, last_logits)
        except Exception as exc:  # noqa: BLE001 — the pool may be torn
            self._reset_after_failure(exc)
            return True
        with self._lock:
            self._counters["prefill_chunks"] += 1
            self._counters["prefill_tokens"] += n
            req.prefilled += n
            if req.prefilled < len(req.context):
                return True
            # Prompt fully prefilled: enter the decode batch.
            req.position = len(req.context)
            if not req.sample_first:
                req.last_token = req.output[-1]
            self._sched.prefilling = None
            req.state = DECODE
            req.remaining = req.max_new_tokens - len(req.output) \
                - (1 if first_token is not None else 0)
            if first_token is not None:
                self._emit(req, first_token)
                req.last_token = first_token
            if req.remaining <= 0 or req.position >= self.max_tokens:
                self._finish_locked(req)
            else:
                self._sched.active.append(req)
        return True

    def _sample_first(self, req: EngineRequest,
                      last_logits: torch.Tensor) -> int:
        temps = torch.tensor([req.temperature], dtype=torch.float32,
                             device=self.device)
        return int(paged_model.sample(last_logits[None, :], temps,
                                      self._generator)[0])

    def _finish_locked(self, req: EngineRequest) -> None:
        self._sched.cache.release(req.block_table)
        if req in self._sched.active:
            self._sched.active.remove(req)
        self._counters["finished"] += 1
        req.sealed = True
        if req.stream is not None:
            req.stream.put(("end", None))
        req.done.set()

    def _decode_tick(self) -> bool:
        with self._lock:
            if not self._sched.active:
                return False
            # Grow every row's table for the token it is about to write;
            # pressure preempts lowest-progress rows.
            for req in list(self._sched.active):
                if req not in self._sched.active:
                    continue  # already preempted as a victim
                self._grow_or_preempt_locked(req, req.position + 1)
            active = list(self._sched.active)
            if not active:
                return True  # everything preempted: progress made
            rows = self.max_batch
            tokens = np.zeros((rows, 1), dtype=np.int64)
            positions = np.zeros((rows,), dtype=np.int64)
            tables = np.zeros((rows, self.blocks_per_seq), dtype=np.int64)
            temps = np.zeros((rows,), dtype=np.float32)
            for i, req in enumerate(active):
                tokens[i, 0] = req.last_token
                positions[i] = req.position
                tables[i, :len(req.block_table)] = req.block_table
                temps[i] = req.temperature

        try:
            nxt, self._pool = self._decode_step(
                self.params, self._pool, self._to_device(tokens),
                self._to_device(positions), self._to_device(tables),
                self._generator, self._to_device(temps))
            nxt = nxt.cpu().numpy()
        except Exception as exc:  # noqa: BLE001 — the pool may be torn
            self._reset_after_failure(exc)
            return True
        with self._lock:
            self._counters["decode_steps"] += 1
            if len(active) >= 2:
                self._counters["batched_decode_steps"] += 1
            self._counters["decode_tokens"] += len(active)
            for i, req in enumerate(active):
                if req.sealed or req not in self._sched.active:
                    continue  # expired or sealed from outside mid-step
                self._emit(req, int(nxt[i]))
                req.last_token = int(nxt[i])
                req.position += 1
                req.remaining -= 1
                if req.remaining <= 0 or req.position >= self.max_tokens:
                    self._finish_locked(req)
        return True

    def _drain_locked(self) -> "list[EngineRequest]":
        """Remove every request from every seat, free its blocks, and
        return them (caller holds the lock and seals them outside it)."""
        sched = self._sched
        victims = list(sched.waiting) + list(sched.active)
        if sched.prefilling is not None:
            victims.append(sched.prefilling)
        sched.waiting.clear()
        sched.active.clear()
        sched.prefilling = None
        for req in victims:
            sched.cache.release(req.block_table)
        return victims

    def _reset_after_failure(self, exc: Exception) -> None:
        """A failed step may have left the pool half written: fail every
        in-flight request with the error and rebuild the pool."""
        with self._lock:
            victims = self._drain_locked()
        for req in victims:
            self._seal(req, exc)
        self._pool = PagedKVCache.init_pool(
            self.config, self._sched.cache.num_blocks, self.block_size,
            device=self.device)

    # ---------------------------------------------------------------- stats

    def engine_stats(self) -> dict:
        """Monotonic counters (``ENGINE_STAT_KEYS``)."""
        out = {key: int(self._counters.get(key, 0))
               for key in ENGINE_STAT_KEYS}
        out["blocks_allocated"] = int(self._sched.cache.blocks_allocated)
        out["blocks_freed"] = int(self._sched.cache.blocks_freed)
        return out

    def engine_load(self) -> dict:
        """Live gauges (the autoscaler's feed; not counters)."""
        with self._lock:
            return {
                "depth": self._sched.depth(),
                "waiting": len(self._sched.waiting),
                "active": len(self._sched.active),
                "free_blocks": self._sched.cache.free_blocks,
            }

    # ------------------------------------------------------------ lifecycle

    def check_health(self) -> None:
        if self._loop_error is not None:
            raise RuntimeError("LLM engine loop died") from self._loop_error
        if not self._loop_thread.is_alive() \
                and not self._shutdown.is_set():
            raise RuntimeError("LLM engine loop died")

    def shutdown(self) -> None:
        """Stop the loop, seal every in-flight request with a
        RuntimeError, join the loop thread, and let go of the KV pool and
        the weights. A sealed error that was raised keeps the frames it
        passed, and through them this engine, in a reference cycle until
        the collector runs: the pool must not wait for that."""
        self._shutdown.set()
        with self._lock:
            self._lock.notify_all()
            victims = self._drain_locked()
        for req in victims:
            self._seal(req, RuntimeError("LLM engine shut down"))
        if self._loop_thread is threading.current_thread():
            return  # the loop ends at its next check and cannot join itself
        self._loop_thread.join(timeout=5.0)
        if not self._loop_thread.is_alive():
            self._pool = self.params = None

    def __del__(self):
        shutdown = getattr(self, "_shutdown", None)  # None if __init__ raised
        if shutdown is not None:
            shutdown.set()


def merged_engine_stats() -> "dict | None":
    """``ENGINE_STAT_KEYS`` summed over this process's live engines, or
    None when it hosts none (its heartbeat then has no ``engine``
    group)."""
    engines = list(_LIVE)
    if not engines:
        return None
    out = {key: 0 for key in ENGINE_STAT_KEYS}
    for engine in engines:
        for key, value in engine.engine_stats().items():
            out[key] += int(value)
    return out


def merged_engine_load() -> dict:
    """The load of this process's live engines, summed."""
    totals = {"depth": 0, "waiting": 0, "active": 0, "free_blocks": 0}
    for engine in list(_LIVE):
        for key, value in engine.engine_load().items():
            totals[key] += int(value)
    return totals
