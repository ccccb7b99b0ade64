"""The paged LLM engine: the PyTorch port against the JAX package.

The JAX init's parameters, as numpy arrays, go into both packages
(``params_from_numpy`` for the port), on the float32 tiny config; the
port runs on the CPU (its norms through the plain RMSNorm version).

- ``_forward_paged``: logits and the updated pool against the reference's
  for a padded prefill chunk and then a decode step, MHA and GQA, to atol
  1e-5 (float32, the same arithmetic; sums in another order).
- The engine: greedy outputs token-identical to the reference engine's on
  the same weights, for concurrent ragged prompts and under preemption.
  Every other engine behaviour (interleave, streaming, typed sheds,
  deadline stages, the server) is checked on the port alone. One JAX
  engine serves every reference output.
- Kv-cache, scheduler and latency-policy cases mirror
  tests/test_llm_engine.py.
"""

import dataclasses
import gc
import threading
import time
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jax_llama
from ray_tpu.serve.llm_engine import model as jax_paged
from ray_tpu_torch.exceptions import (
    CacheExhaustedError,
    SystemOverloadedError,
    TaskTimeoutError,
)
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.serve.llm_engine import (
    ENGINE_STAT_KEYS,
    LatencyPolicy,
    LLMEngine,
    LLMEngineServer,
    PagedKVCache,
)
from ray_tpu_torch.serve.llm_engine import model as paged
from ray_tpu_torch.serve.llm_engine.scheduler import (
    DECODE,
    EngineRequest,
    Scheduler,
)

LOGIT_TOL = dict(atol=1e-5, rtol=0)
ENGINE = dict(max_batch_size=4, max_seq_len=64, block_size=8,
              prefill_chunk=8, seed=0)
# Ragged prompts, 1 to 21 tokens (up to three prefill chunks of 8).
PROMPTS = [[5, 9, 2, 7], [1], [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5],
           list(range(1, 22)), [11, 12, 13, 14], [200, 100]]
PRESSURE_PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 12, 13, 14]]


def _configs(kv_heads: int = 4):
    jax_cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  num_kv_heads=kv_heads, dtype=jnp.float32)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(),
                              num_kv_heads=kv_heads, dtype=torch.float32)
    return jax_cfg, cfg


def _weights(jax_cfg):
    jax_params = jax_llama.init_params(jax_cfg, jax.random.PRNGKey(0))
    return jax_params, params_from_numpy(jax.tree.map(np.asarray, jax_params),
                                         "cpu")


def _generate(engine, prompts, max_new_tokens=8):
    """Submit every prompt at once from its own thread; outputs in prompt
    order."""
    results = {}

    def gen(i):
        req = engine.submit(prompts[i], max_new_tokens=max_new_tokens)
        results[i] = engine.result(req, timeout_s=120)

    threads = [threading.Thread(target=gen, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=150)
    assert not any(t.is_alive() for t in threads)
    return [results[i] for i in range(len(prompts))]


@pytest.fixture(scope="module")
def weights():
    jax_cfg, cfg = _configs()
    return (jax_cfg, cfg, *_weights(jax_cfg))


@pytest.fixture(scope="module")
def reference(weights):
    """The reference engine's greedy outputs on the shared weights (the
    one JAX engine of this file)."""
    from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

    jax_cfg, _, jax_params, _ = weights
    engine = JaxEngine(jax_cfg, jax_params, **ENGINE)
    try:
        concurrent = _generate(engine, PROMPTS)
        pressure = [engine.result(engine.submit(p, max_new_tokens=12),
                                  timeout_s=120) for p in PRESSURE_PROMPTS]
        unary = engine.result(engine.submit([5, 9, 2, 7], max_new_tokens=5),
                              timeout_s=120)
    finally:
        engine.shutdown()
    return {"concurrent": concurrent, "pressure": pressure, "unary": unary}


@pytest.fixture(scope="module")
def engine(weights):
    _, cfg, _, params = weights
    engine = LLMEngine(cfg, params, device="cpu", **ENGINE)
    yield engine
    engine.shutdown()


# ------------------------------------------------------------ paged forward


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
def test_forward_paged_matches_jax(kv_heads):
    """A prefill chunk of 8 with 5 real tokens (3 padded to scratch), then
    a decode step of 2 rows (one live at position 5, one inactive): logits
    and the whole pool, scratch block included, after each call."""
    jax_cfg, cfg = _configs(kv_heads)
    jax_params, params = _weights(jax_cfg)
    bs, num_blocks = 4, 6
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, 5)
    jax_pool = {"k": jnp.zeros((cfg.num_layers, num_blocks, bs,
                                kv_heads, cfg.head_dim), jnp.float32)}
    jax_pool["v"] = jax_pool["k"]
    pool = PagedKVCache.init_pool(cfg, num_blocks, bs, device="cpu")

    tokens = np.zeros((1, 8), np.int64)
    tokens[0, :5] = prompt
    positions = np.zeros((1, 8), np.int64)
    positions[0, :5] = np.arange(5)
    table = np.array([[3, 1, 0]], np.int64)
    decode = (np.array([[int(rng.integers(1, cfg.vocab_size))], [0]]),
              np.array([[5], [0]]), np.array([[3, 1, 0], [0, 0, 0]]))
    calls = [(tokens, positions, table, 5), (*decode, None)]
    for toks, pos, tables, n_valid in calls:
        want, jax_pool = jax_paged._forward_paged(
            jax_params, jax_pool, jnp.asarray(toks, jnp.int32),
            jnp.asarray(pos, jnp.int32), jnp.asarray(tables, jnp.int32),
            jax_cfg, bs, n_valid=None if n_valid is None
            else jnp.int32(n_valid))
        got, pool = paged._forward_paged(
            params, pool, torch.tensor(toks), torch.tensor(pos),
            torch.tensor(tables), cfg, bs, n_valid=n_valid)
        assert got.shape == (toks.shape[0], toks.shape[1], cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(pool[key].numpy(),
                                       np.asarray(jax_pool[key]),
                                       **LOGIT_TOL)
    # The live row's k/v went to block 1 offset 1 (position 5), the
    # inactive row's and the padding's to scratch block 0.
    assert pool["k"][:, 1, 1].abs().sum() > 0
    assert pool["k"][:, 2].abs().sum() == 0


def test_sampling_greedy_rows_and_temperature_rows():
    logits = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.0, 1.0]])
    gen = torch.Generator().manual_seed(0)
    out = paged.sample(logits, torch.tensor([0.0, 0.0]), gen)
    assert out.tolist() == [1, 0] and out.dtype == torch.int32
    # A hot row draws every token; a near-zero temperature is argmax.
    draws = {int(paged.sample(logits, torch.tensor([1e-6, 50.0]), gen)[1])
             for _ in range(200)}
    assert draws == {0, 1, 2}
    assert paged.sample(logits, torch.tensor([1e-6, 1e-6]), gen).tolist() \
        == [1, 0]


# ------------------------------------------------- kv cache and scheduler


def _cache_alloc_free_exhaustion():
    cache = PagedKVCache(num_blocks=5, block_size=8, max_blocks_per_seq=4)
    assert cache.free_blocks == 4  # block 0 is reserved scratch
    table: list = []
    assert cache.grow(table, 1) is True
    assert cache.grow(table, 8) is False  # same block covers 8 tokens
    assert cache.grow(table, 9) is True
    assert len(table) == 2 and 0 not in table
    other: list = []
    cache.grow(other, 16)
    assert cache.free_blocks == 0
    with pytest.raises(CacheExhaustedError):
        cache.grow(table, 17)
    cache.release(other)
    assert cache.free_blocks == 2 and other == []
    cache.grow(table, 17)
    assert cache.blocks_allocated == 5 and cache.blocks_freed == 2
    with pytest.raises(CacheExhaustedError):
        cache.grow(table, 8 * 4 + 1)  # over the per-sequence table cap
    assert cache.fits_ever(32) and not cache.fits_ever(33)


def _scheduler_preempts_lowest_progress():
    cache = PagedKVCache(num_blocks=9, block_size=8, max_blocks_per_seq=8)
    sched = Scheduler(cache, max_batch=4, max_waiting=4,
                      max_tokens_per_seq=64)
    reqs = []
    for progress in [5, 2, 9]:
        req = EngineRequest([1, 2, 3], 16, 0.0)
        req.output = list(range(progress))
        sched.active.append(req)
        reqs.append(req)
    assert sched.pick_victim() is reqs[1]  # fewest generated tokens
    cache.grow(reqs[1].block_table, 16)
    sched.preempt(reqs[1])
    assert reqs[1] not in sched.active and sched.waiting[0] is reqs[1]
    assert reqs[1].block_table == [] and cache.free_blocks == 8
    claimed = sched.claim_prefill()
    assert claimed is reqs[1]
    assert claimed.context == reqs[1].tokens + reqs[1].output[:-1]
    assert claimed.sample_first is False


def _scheduler_bounded_queue_and_never_fits():
    cache = PagedKVCache(num_blocks=3, block_size=8, max_blocks_per_seq=8)
    sched = Scheduler(cache, max_batch=2, max_waiting=1,
                      max_tokens_per_seq=64)
    sched.try_enqueue(EngineRequest([1], 4, 0.0))
    with pytest.raises(CacheExhaustedError):
        sched.try_enqueue(EngineRequest([1], 4, 0.0))  # queue full
    sched.waiting.clear()
    with pytest.raises(CacheExhaustedError):
        # 2 usable blocks = 16 tokens; a 20-token need never fits.
        sched.try_enqueue(EngineRequest(list(range(10)), 10, 0.0))


def _scheduler_deadline_sweep_stages():
    cache = PagedKVCache(num_blocks=5, block_size=8, max_blocks_per_seq=4)
    sched = Scheduler(cache, max_batch=2, max_waiting=4,
                      max_tokens_per_seq=32)
    waiting = EngineRequest([1], 4, 0.0, deadline=time.time() - 1)
    decoding = EngineRequest([1], 4, 0.0, deadline=time.time() - 1)
    decoding.state = DECODE
    cache.grow(decoding.block_table, 8)
    live = EngineRequest([1], 4, 0.0, deadline=time.time() + 60)
    sched.waiting.extend([waiting, live])
    sched.active.append(decoding)
    assert set(sched.sweep_expired()) == {waiting, decoding}
    assert live in sched.waiting and decoding not in sched.active
    assert cache.free_blocks == 4  # expired blocks reclaimed
    assert sched.expired_error(waiting).stage == "llm_queue"
    assert sched.expired_error(decoding).stage == "llm_decode"


BOOKKEEPING = {
    "cache_alloc_free_exhaustion": _cache_alloc_free_exhaustion,
    "scheduler_preempts_lowest_progress": _scheduler_preempts_lowest_progress,
    "scheduler_bounded_queue_and_never_fits":
        _scheduler_bounded_queue_and_never_fits,
    "scheduler_deadline_sweep_stages": _scheduler_deadline_sweep_stages,
}


@pytest.mark.parametrize("case", sorted(BOOKKEEPING))
def test_cache_and_scheduler(case):
    BOOKKEEPING[case]()


# -------------------------------------------------------------- the engine


def test_greedy_concurrent_ragged_matches_jax_engine(engine, reference):
    before = engine.engine_stats()["batched_decode_steps"]
    assert _generate(engine, PROMPTS) == reference["concurrent"]
    assert engine.engine_stats()["batched_decode_steps"] > before


def test_paged_decode_matches_full_forward(engine):
    """Greedy paged decode equals greedy decoding with the full-context
    forward (plain attention, plain norm) on the same weights."""
    prompt = [5, 9, 2, 7, 100, 3, 8, 8, 1, 40]
    out = engine.result(engine.submit(prompt, max_new_tokens=6),
                        timeout_s=120)
    toks, expected = list(prompt), []
    for _ in range(6):
        logits = llama.forward(engine.params, torch.tensor([toks]),
                               engine.config)
        expected.append(int(torch.argmax(logits[0, -1])))
        toks.append(expected[-1])
    assert out == expected


def test_preemption_resume_matches_pressure_free(engine, reference):
    """5 usable blocks of 8 across four 2-block sequences: cache pressure
    preempts, resume recomputes, and every output equals the
    pressure-free run's (the reference engine's), each request finishing
    once."""
    pressured = LLMEngine(engine.config, engine.params, device="cpu",
                          num_blocks=6, **ENGINE)
    try:
        assert _generate(pressured, PRESSURE_PROMPTS, 12) \
            == reference["pressure"]
        stats = pressured.engine_stats()
        assert stats["preemptions"] > 0 and stats["resumes"] > 0, stats
        assert stats["finished"] == len(PRESSURE_PROMPTS)
    finally:
        pressured.shutdown()


def test_streaming_tokens_overlap_decode(engine):
    req = engine.submit([3, 1, 4], max_new_tokens=12, stream=True)
    got = []
    for token in engine.stream_tokens(req):
        got.append(token)
        if len(got) == 1:
            assert not req.done.is_set() or len(req.output) < 12
    assert got == req.output and len(got) == 12


def test_chunked_prefill_interleaves_with_decode(engine):
    """A 40-token prompt prefills in 5 chunks between decode steps: the
    in-flight stream keeps emitting while it loads."""
    a = engine.submit([7, 7, 7], max_new_tokens=24, stream=True)
    a_times = []
    collected = threading.Event()

    def consume():
        for _ in engine.stream_tokens(a):
            a_times.append(time.monotonic())
        collected.set()

    thread = threading.Thread(target=consume)
    thread.start()
    while len(a_times) < 2:
        time.sleep(0.005)
    chunks = engine.engine_stats()["prefill_chunks"]
    submitted = time.monotonic()
    b_out = engine.result(engine.submit(list(range(1, 41)),
                                        max_new_tokens=2), timeout_s=120)
    b_done = time.monotonic()
    assert collected.wait(timeout=120)
    thread.join(timeout=10)
    assert not thread.is_alive() and len(b_out) == 2
    assert engine.engine_stats()["prefill_chunks"] - chunks == 5
    assert [t for t in a_times if submitted < t < b_done], (
        "stream A stalled for the whole of B's chunked prefill")


def test_queue_full_and_never_fits_shed_typed(engine):
    small = LLMEngine(engine.config, engine.params, device="cpu",
                      **{**ENGINE, "max_batch_size": 1, "max_waiting": 1,
                         "num_blocks": 5})
    try:
        hog = small.submit([1, 2], max_new_tokens=30)
        deadline = time.monotonic() + 30
        while hog.state == "waiting" and time.monotonic() < deadline:
            time.sleep(0.005)
        # Never fits: 4 usable blocks = 32 tokens; this needs 40.
        with pytest.raises(CacheExhaustedError):
            small.submit(list(range(20)), max_new_tokens=20)
        small.submit([3, 4], max_new_tokens=4)  # fills the queue
        with pytest.raises(CacheExhaustedError) as err:
            small.submit([5, 6], max_new_tokens=4)
        assert isinstance(err.value, SystemOverloadedError)
        stats = small.engine_stats()
        assert stats["shed_queue_full"] == 1 and stats["shed_cache"] == 1
    finally:
        small.shutdown()


def _slow_decode(eng, seconds):
    step = eng._decode_step

    def slow(*args):
        time.sleep(seconds)
        return step(*args)

    eng._decode_step = slow


def test_deadlines_seal_typed_with_their_stage(engine):
    """A budget dying in the queue seals stage llm_queue without the
    request ever decoding; one dying mid-decode seals llm_decode."""
    slow = LLMEngine(engine.config, engine.params, device="cpu",
                     **{**ENGINE, "max_batch_size": 1})
    try:
        _slow_decode(slow, 0.05)
        hog = slow.submit([1, 2], max_new_tokens=40,
                          deadline=time.time() + 1.0)
        parked = slow.submit([3, 4], max_new_tokens=4,
                             deadline=time.time() + 0.15)
        with pytest.raises(TaskTimeoutError) as err:
            slow.result(parked, timeout_s=30)
        assert err.value.stage == "llm_queue" and parked.output == []
        with pytest.raises(TaskTimeoutError) as err:
            slow.result(hog, timeout_s=30)
        assert err.value.stage == "llm_decode" and 0 < len(hog.output) < 40
        # The sweep and the caller-side check may both count one expiry
        # when they race (as in the reference).
        assert slow.engine_stats()["deadline_expired"] >= 2
    finally:
        slow.shutdown()


def test_failed_step_seals_every_request_and_engine_recovers(engine):
    """A step that raises fails every in-flight request with its error,
    re-inits the pool, and the loop goes on serving."""
    eng = LLMEngine(engine.config, engine.params, device="cpu", **ENGINE)
    try:
        step = eng._decode_step
        failures = [RuntimeError("device fault")]

        def failing(*args):
            if failures:
                raise failures.pop()
            return step(*args)

        eng._decode_step = failing
        reqs = [eng.submit(p, max_new_tokens=4) for p in PROMPTS[:2]]
        for req in reqs:
            with pytest.raises(RuntimeError, match="device fault"):
                eng.result(req, timeout_s=30)
        eng.check_health()
        assert eng.engine_load()["free_blocks"] == eng._sched.cache.num_blocks - 1
        out = eng.result(eng.submit([5, 9, 2, 7], max_new_tokens=5),
                         timeout_s=30)
        assert len(out) == 5
    finally:
        eng.shutdown()


def test_shutdown_seals_in_flight_and_refuses_new_work(engine):
    eng = LLMEngine(engine.config, engine.params, device="cpu",
                    **{**ENGINE, "max_batch_size": 1})
    _slow_decode(eng, 0.05)
    req = eng.submit([1, 2, 3], max_new_tokens=40)
    eng.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        eng.result(req, timeout_s=10)
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit([1])
    assert not eng._loop_thread.is_alive()


def test_shutdown_lets_go_of_the_pool_and_the_weights(engine):
    """After a raised, sealed error (whose traceback holds the engine's
    frames in a reference cycle) and shutdown(), the KV pool is freed at
    once, without the collector, and the engine no longer holds the
    weights."""
    eng = LLMEngine(engine.config, engine.params, device="cpu", **ENGINE)
    req = eng.submit([1, 2, 3], max_new_tokens=4, deadline=time.time() - 1)
    with pytest.raises(TaskTimeoutError):
        eng.result(req, timeout_s=30)
    pool = [weakref.ref(t) for t in eng._pool.values()]
    gc.disable()
    try:
        eng.shutdown()
        assert [ref() for ref in pool] == [None, None]
        assert eng.params is None
    finally:
        gc.enable()


def test_engine_stats_and_load_keys(engine):
    assert set(engine.engine_stats()) == set(ENGINE_STAT_KEYS)
    assert set(engine.engine_load()) == {"depth", "waiting", "active",
                                         "free_blocks"}


def test_server_call_and_generate(weights, reference):
    _, cfg, _, params = weights
    server = LLMEngineServer(cfg, params, max_batch_size=2, max_seq_len=64,
                             device="cpu")
    try:
        request = {"tokens": [5, 9, 2, 7], "max_new_tokens": 5}
        assert server(request) == {"tokens": reference["unary"]}
        assert list(server.generate(request)) == reference["unary"]
        with pytest.raises(TaskTimeoutError) as err:
            server({**request, "deadline_s": -1.0})
        assert err.value.stage in ("llm_queue", "llm_decode")
        stats = server.engine_stats()
        assert stats["paged_engine"] is True and stats["finished"] == 2
        assert set(server.serve_metrics()) == {"engine_depth",
                                               "engine_free_blocks"}
        server.check_health()
    finally:
        server.shutdown()


# -------------------------------------------------------- autoscale policy


def _policy_cfg(**overrides):
    fields = dict(min_replicas=1, max_replicas=8,
                  target_ongoing_requests=2.0, metrics_interval_s=0.5,
                  upscale_delay_s=1.0, downscale_delay_s=4.0,
                  target_p99_s=0.1)
    fields.update(overrides)
    return types.SimpleNamespace(**fields)


def test_latency_policy_scales_up_on_p99_skew():
    policy = LatencyPolicy(_policy_cfg())
    assert policy.desired(2, p99_s=0.4, depth=4.0, now=100.0) == 4
    assert policy.desired(4, p99_s=0.4, depth=4.0, now=100.5) == 4
    assert policy.desired(4, p99_s=0.4, depth=4.0, now=101.5) == 8
    fresh = LatencyPolicy(_policy_cfg())
    assert fresh.desired(1, p99_s=0.12, depth=10.0, now=10.0) == 5


def test_latency_policy_scales_down_to_min_when_idle():
    policy = LatencyPolicy(_policy_cfg(downscale_delay_s=1.0))
    now, current = 50.0, 4
    for _ in range(8):
        desired = policy.desired(current, p99_s=0.01, depth=0.0, now=now)
        assert desired in (current, current - 1)
        current = desired
        now += 1.5
    assert current == 1


def test_latency_policy_damps_flapping_and_stale_feed():
    policy = LatencyPolicy(_policy_cfg(upscale_delay_s=1.0,
                                       downscale_delay_s=5.0))
    assert policy.desired(2, p99_s=0.4, depth=4.0, now=10.0) == 4
    assert policy.desired(4, p99_s=0.01, depth=0.0, now=12.0) == 4
    assert policy.desired(4, p99_s=0.01, depth=0.0, now=14.9) == 4
    assert policy.desired(4, p99_s=0.01, depth=0.0, now=15.5) == 3
    assert policy.desired(3, p99_s=9.9, depth=99.0, now=30.0,
                          feed_age_s=60.0) == 3
