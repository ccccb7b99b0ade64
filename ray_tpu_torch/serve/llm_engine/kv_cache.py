"""Paged KV cache: a preallocated block pool + per-request block tables.

The port of ``ray_tpu/serve/llm_engine/kv_cache.py``. The cache is a pool
of fixed-size blocks (``[num_blocks, block_size, kv_heads, head_dim]`` per
layer) and each request holds an append-only table of the block ids that
cover the tokens it has written; blocks return to the free list the moment
a request finishes, so ragged lengths pack tightly.

Block 0 is a reserved scratch block: inactive batch rows and padded
prefill positions scatter their k/v there, and no real query ever reads it
(it appears only in a table's padding tail, past every real position).

Thread model: allocation and free run only on the engine loop thread; the
counters are read from other threads for stats.
"""

from __future__ import annotations

from typing import Any

import torch

from ray_tpu_torch._private.device import resolve_device
from ray_tpu_torch.exceptions import CacheExhaustedError


class PagedKVCache:
    """Host-side accounting of the paged pool's blocks; the device tensors
    live in the engine, which updates them in place."""

    def __init__(self, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int):
        if num_blocks < 2:
            raise ValueError("paged cache needs >= 2 blocks "
                             "(block 0 is reserved scratch)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = max_blocks_per_seq
        # LIFO free list: freshly freed blocks are reused first. Block 0
        # is never in it.
        self._free = list(range(num_blocks - 1, 0, -1))
        self.blocks_allocated = 0
        self.blocks_freed = 0

    # ------------------------------------------------------------- queries

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def usable_blocks(self) -> int:
        """Blocks a single request could ever hold (pool minus scratch,
        capped by its table width)."""
        return min(self.num_blocks - 1, self.max_blocks_per_seq)

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """Table length needed to hold ``n_tokens`` written tokens."""
        return -(-n_tokens // self.block_size)

    def fits_ever(self, total_tokens: int) -> bool:
        """Whether a request needing ``total_tokens`` KV slots can run even
        on an empty pool (a request that never fits sheds at admission)."""
        return self.blocks_for_tokens(total_tokens) <= self.usable_blocks

    # ---------------------------------------------------------- alloc/free

    def grow(self, table: "list[int]", n_tokens: int) -> bool:
        """Extend ``table`` in place until it covers ``n_tokens`` token
        slots. Returns True when blocks were appended. Raises
        :class:`CacheExhaustedError` when the free list runs dry (the
        scheduler then preempts a victim and retries)."""
        need = self.blocks_for_tokens(n_tokens)
        if need > self.max_blocks_per_seq:
            raise CacheExhaustedError(
                f"request needs {need} blocks, over the per-sequence "
                f"table limit {self.max_blocks_per_seq}")
        grew = False
        while len(table) < need:
            if not self._free:
                raise CacheExhaustedError(
                    f"KV block pool exhausted ({self.num_blocks - 1} "
                    f"blocks, 0 free)")
            table.append(self._free.pop())
            self.blocks_allocated += 1
            grew = True
        return grew

    def release(self, table: "list[int]") -> None:
        """Return every block in ``table`` to the free list and clear the
        table."""
        for block in table:
            if block != 0:
                self._free.append(block)
                self.blocks_freed += 1
        table.clear()

    # --------------------------------------------------------------- pools

    @staticmethod
    def init_pool(config: Any, num_blocks: int, block_size: int,
                  dtype: "torch.dtype | None" = None, device=None) -> dict:
        """The zeroed pool ``{"k", "v"}: [layers, num_blocks, block_size,
        kv, d]`` on ``device`` (the engine's; raises without a card unless
        ``device="cpu"``)."""
        device = resolve_device(device)
        dtype = dtype or config.dtype
        shape = (config.num_layers, num_blocks, block_size,
                 config.num_kv_heads, config.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
