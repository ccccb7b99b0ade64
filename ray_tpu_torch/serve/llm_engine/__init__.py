"""LLM inference engine: paged KV-cache continuous batching.

The port of ``ray_tpu/serve/llm_engine/``: ragged request lengths share
one fixed-shape decode batch through a paged KV cache (fixed-size blocks
in a preallocated pool, per-request block tables, gather-by-block-table
attention), and a prefill/decode scheduler interleaves chunked prefill
with decode steps so long prompts cannot stall in-flight streams.

Layout:

- ``kv_cache``  the paged block pool + per-request block tables
- ``model``     the gather-by-block-table prefill/decode steps (norms
  through the RMSNorm kernel)
- ``scheduler`` request lifecycle: bounded admission, chunked-prefill
  interleave, preemption on cache pressure, deadline sweep
- ``engine``    the engine loop + counters (``ENGINE_STAT_KEYS``)
- ``server``    the ``LLMEngineServer`` deployment class
- ``autoscale`` the latency-driven replica-count policy
"""

from ray_tpu_torch.exceptions import CacheExhaustedError
from ray_tpu_torch.serve.llm_engine.autoscale import LatencyPolicy
from ray_tpu_torch.serve.llm_engine.engine import ENGINE_STAT_KEYS, LLMEngine
from ray_tpu_torch.serve.llm_engine.kv_cache import PagedKVCache
from ray_tpu_torch.serve.llm_engine.server import LLMEngineServer

__all__ = [
    "CacheExhaustedError", "ENGINE_STAT_KEYS", "LLMEngine",
    "LLMEngineServer", "LatencyPolicy", "PagedKVCache",
]
