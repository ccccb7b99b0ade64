"""Host cost of the RMSNorm kernel's launch path at the serving decode
shape, x [8, 4096] bf16 with a bf16 scale, on one CUDA card.

At that shape the kernel runs about 2 us on the device, so the Python path
that reaches it sets the time of a call. This script times each of the
pieces below in host microseconds per call: ``time.perf_counter`` over
back-to-back calls, in rounds that take the pieces in turn, the median of
the rounds. A kernel that short keeps up with its launches, so a launch's
time here is the cost of the path to it.

- the entry points whole: ``rms_norm_kernel``; ``rms_norm``,
  ``rms_norm_fwd`` and ``RMSNorm.apply`` under ``no_grad``; and
  ``torch.nn.functional.rms_norm`` as the yardstick;
- the wrapper's pieces: ``torch.empty_like``, ``_build.launch`` (the
  ctypes call included), the raw stream handle, a ``no_grad`` context;
- what a launch path can take in their place: ``torch.empty`` with a
  device, a ``torch.cuda.device`` context, ``current_stream().cuda_stream``;
- how the launch's six scalars cross to C: a no-op C function with the
  entry point's ten arguments against ``struct`` packing plus a no-op
  function of five (host code built here with nvcc).

Run from the repo root: ``python3 rmsnorm_launch_cost.py``. It prints the
card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import struct
import subprocess
import sys
import time

import torch

CALLS, ROUNDS, EPS = 10_000, 5, 1e-5
STUB = r"""
struct Packed { int x_dtype, scale_dtype, rows, d; long long stride; float eps; };
extern "C" int ten(const void*, const void*, void*, int, int, int, int,
                   long long, float, void*) { return 0; }
extern "C" int five(const void*, const void*, void*, const Packed*, void*) {
  return 0;
}
"""


def host_us(pieces: dict) -> dict:
    """Median over ROUNDS rounds of each piece's host us per call."""
    for fn in pieces.values():
        for _ in range(100):
            fn()
    torch.cuda.synchronize()
    per_round = {name: [] for name in pieces}
    for _ in range(ROUNDS):
        for name, fn in pieces.items():
            start = time.perf_counter()
            for _ in range(CALLS // ROUNDS):
                fn()
            elapsed = time.perf_counter() - start
            torch.cuda.synchronize()
            per_round[name].append(1e6 * elapsed / (CALLS // ROUNDS))
    return {name: statistics.median(us) for name, us in per_round.items()}


def stub_library(build) -> ctypes.CDLL:
    """The two no-op functions, built with the kernels' nvcc."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = build.BUILD_DIR / "launch_cost_stub.cu"
    target = build.BUILD_DIR / "liblaunch_cost_stub.so"
    source.write_text(STUB)
    subprocess.run([build._nvcc(), "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(target), str(source)], check=True)
    lib = ctypes.CDLL(str(target))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ten.argtypes = [p, p, p, i, i, i, i, ctypes.c_longlong,
                        ctypes.c_float, p]
    lib.five.argtypes = [p, p, p, ctypes.c_char_p, p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("rmsnorm_launch_cost: no CUDA device", file=sys.stderr)
        return 1
    from ray_tpu_torch.ops import _build, fused

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    gen = torch.Generator("cuda").manual_seed(0)
    x = torch.randn((8, 4096), generator=gen, device="cuda").bfloat16()
    scale = torch.randn(4096, generator=gen, device="cuda").bfloat16()
    lib, stub = fused._lib(), stub_library(_build)
    index, out = x.get_device(), torch.empty_like(x)
    ptrs = (x.data_ptr(), scale.data_ptr(), out.data_ptr())
    scalars = (1, 1, 8, 4096, x.stride(0), EPS)
    packed = struct.Struct("@iiiiqf")
    stream = torch._C._cuda_getCurrentRawStream(index)

    def under_no_grad(fn):
        def call():
            with torch.no_grad():
                return fn(x, scale, EPS)
        return call

    def device_context():
        with torch.cuda.device(x.device):
            pass

    costs = host_us({
        "rms_norm_kernel": lambda: fused.rms_norm_kernel(x, scale, EPS),
        "F.rms_norm": lambda: torch.nn.functional.rms_norm(
            x, (4096,), scale, EPS),
        "rms_norm under no_grad": under_no_grad(fused.rms_norm),
        "rms_norm_fwd under no_grad": under_no_grad(fused.rms_norm_fwd),
        "RMSNorm.apply under no_grad": under_no_grad(fused.RMSNorm.apply),
        "no_grad context alone": under_no_grad(lambda *a: None),
        "torch.empty_like": lambda: torch.empty_like(x),
        "torch.empty(device=x.device)": lambda: torch.empty(
            x.shape, dtype=x.dtype, device=x.device),
        "_build.launch (ctypes call included)": lambda: _build.launch(
            lib.rtt_rmsnorm, index, *ptrs, fused._RMS_ARGS.pack(*scalars)),
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(
            index),
        "torch.cuda.device context": device_context,
        "current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
        "no-op C call, 10 arguments": lambda: stub.ten(
            *ptrs, *scalars, stream),
        "struct pack + no-op C call, 5 arguments": lambda: stub.five(
            *ptrs, packed.pack(*scalars), stream),
        "struct pack alone": lambda: packed.pack(*scalars),
    })
    costs["checks and the rest (by difference)"] = (
        costs["rms_norm_kernel"] - costs["torch.empty_like"]
        - costs["_build.launch (ctypes call included)"]
        - costs["struct pack alone"])
    print(json.dumps({"shape": [8, 4096], "dtype": "bfloat16",
                      "calls": CALLS, "rounds": ROUNDS,
                      "host_us_per_call": costs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
