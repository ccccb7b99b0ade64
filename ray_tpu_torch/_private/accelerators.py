"""Accelerator detection: the node's ``GPU`` resource.

The port of ``ray_tpu/_private/accelerators.py``, which finds TPUs only.
Here the head node's ``GPU`` count is ``torch.cuda.device_count()``: it
honours ``CUDA_VISIBLE_DEVICES`` and asks NVML, so detection creates no
CUDA context in the process (one that later forks workers must not hold
one). ``RAY_TPU_TORCH_NUM_GPUS`` overrides the count and
``RAY_TPU_TORCH_SKIP_GPU_DETECTION`` skips detection, as
``RAY_TPU_NUM_TPU_CHIPS`` and ``RAY_TPU_SKIP_TPU_DETECTION`` do for the
reference.

A ``GPU`` lease also names its cards (``CardLedger``): an in-thread task
or actor runs on its first card (``torch.cuda.set_device``), and a
process actor sees exactly its cards in ``CUDA_VISIBLE_DEVICES``.
"""

from __future__ import annotations

import os

import torch


def detect_resources() -> dict[str, float]:
    """``{"GPU": count}`` where the count is above 0, else ``{}``."""
    override = os.environ.get("RAY_TPU_TORCH_NUM_GPUS")
    if override is not None:
        count = float(override)
    elif os.environ.get("RAY_TPU_TORCH_SKIP_GPU_DETECTION"):
        count = 0.0
    else:
        count = float(torch.cuda.device_count())
    return {"GPU": count} if count > 0 else {}


class CardLedger:
    """Which cards a ``GPU`` lease holds: the free share of each card of
    a node (or of a placement-group bundle).

    A lease of whole units takes that many whole free cards; a fractional
    one takes a share of one card, the card a co-tenant already sits on
    where one has room. Leases are ``{card index: share}``; the indices
    count the cards this process sees."""

    def __init__(self, shares: dict[int, float]):
        self.capacity = dict(shares)
        self.free = dict(shares)

    @classmethod
    def for_count(cls, count: float) -> "CardLedger":
        whole = int(count + 1e-9)
        shares = {i: 1.0 for i in range(whole)}
        if count - whole > 1e-9:
            shares[whole] = count - whole
        return cls(shares)

    def pick(self, amount: float) -> "dict[int, float] | None":
        """The shares a lease of ``amount`` would take now, or None."""
        if amount <= 1e-9:
            return {}
        whole = int(amount + 1e-9)
        part = amount - whole
        free_cards = [i for i in sorted(self.free)
                      if self.free[i] >= 1.0 - 1e-9]
        if len(free_cards) < whole:
            return None
        shares = {i: 1.0 for i in free_cards[:whole]}
        if part > 1e-9:
            # A co-tenant's card first, then the lowest free one.
            fits = [i for i in sorted(self.free) if i not in shares
                    and self.free[i] + 1e-9 >= part]
            if not fits:
                return None
            shares[min(fits, key=lambda i: (
                self.free[i] >= self.capacity[i] - 1e-9, i))] = part
        return shares

    def take(self, shares: dict[int, float]) -> None:
        for i, share in shares.items():
            self.free[i] -= share

    def give(self, shares: dict[int, float]) -> None:
        for i, share in shares.items():
            self.free[i] = min(self.capacity.get(i, 0.0),
                               self.free.get(i, 0.0) + share)
