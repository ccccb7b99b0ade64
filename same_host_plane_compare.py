"""chip_smoke.py's node phases with the same-host plane off, then on, in
one run on one CUDA card.

The plane is the reference's ``same_host_plane`` knob
(``RAY_TPU_TORCH_SAME_HOST_PLANE``; the daemons, the head and the second
driver these phases start inherit it). Off, a daemon reads another
daemon's result, and the driver a daemon's, by the chunked pull over
loopback RPC; on, by one copy out of the holder's shared-memory segment
under a lease. Each run of ``node_cluster`` and ``head_restart`` prints
its JSON line with ``same_host_plane`` set as it ran, and its checks
hold as in chip_smoke.py (on: the map path and no chunk in
node_cluster's step (a); off: the chunked pull), so the two sets of
rates (node_cluster's ``kernels`` and head_restart's
``driver_get_paths``) come from the same card in the same call.

Before them it runs the phases of chip_smoke.py whose results the two
take, as chip_smoke.py's ``main`` does: device, build, train
(node_cluster's GPU gang is held to its steps), serve, runtime and
process_serve. Run from the repo root:
``python3 same_host_plane_compare.py``. It prints the card's name and
power limit, every phase's JSON line and a last ``phase_walls`` line.
"""

from __future__ import annotations

import importlib
import os
import runpy
import sys

import torch

PLANE_ENV = "RAY_TPU_TORCH_SAME_HOST_PLANE"


def main() -> int:
    if not torch.cuda.is_available():
        print("same_host_plane_compare: no CUDA device", file=sys.stderr)
        return 1
    # Loaded, not imported: a function of chip_smoke's then pickles by
    # value, so a daemon or a gang process never imports this script.
    here = os.path.dirname(os.path.abspath(__file__))
    smoke = runpy.run_path(os.path.join(here, "chip_smoke.py"),
                           run_name="chip_smoke_phases")["main"].__globals__
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.parallel import train_step

    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    fused = importlib.import_module("ray_tpu_torch.ops.fused")
    timed = smoke["timed"]
    device, power = timed(smoke["phase_device"])
    timed(smoke["phase_build"], _build, fa)
    train = timed(smoke["phase_train"], llama, train_step, fa, device, power)
    torch.cuda.empty_cache()
    served = timed(smoke["phase_serve"], llama, fused, device, power)
    _, runtime_result = timed(smoke["phase_runtime"], llama, fa, fused,
                              served, device, power)
    result, tokens = served["result"], served["tokens"]
    del served
    torch.cuda.empty_cache()
    process_summary = timed(smoke["phase_process_serve"], llama, result,
                            tokens, runtime_result, device,
                            power)["summary"]
    torch.cuda.empty_cache()
    prior = os.environ.get(PLANE_ENV)
    walls = {}
    try:
        for plane in ("0", "1"):
            os.environ[PLANE_ENV] = plane
            GLOBAL_CONFIG.reset()
            timed(smoke["phase_node_cluster"], llama, fa, fused, result,
                  tokens, process_summary, runtime_result, train, device,
                  power)
            torch.cuda.empty_cache()
            timed(smoke["phase_head_restart"], llama, fa, fused, tokens,
                  device, power)
            torch.cuda.empty_cache()
            walls[f"plane_{plane}"] = {
                k: smoke["PHASE_WALLS"][k]
                for k in ("node_cluster", "head_restart")}
    finally:
        if prior is None:
            os.environ.pop(PLANE_ENV, None)
        else:
            os.environ[PLANE_ENV] = prior
        GLOBAL_CONFIG.reset()
    smoke["emit"]("phase_walls", walls_s=walls, card=device["kind"],
                  nvidia_smi=power)
    return 0


if __name__ == "__main__":
    sys.exit(main())
