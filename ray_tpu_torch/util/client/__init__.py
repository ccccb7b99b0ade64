"""The client server: the driver's endpoint for the public API called
from its worker processes (``ClientServer``). The reference's remote
driver, ``connect()`` (``ray_tpu/util/client/api.py``), is not ported
(ROADMAP queue 1, item 12)."""

from ray_tpu_torch.util.client.server import ClientServer

__all__ = ["ClientServer"]
