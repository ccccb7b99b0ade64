"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``build/ray_tpu_torch/lib<name>-<hash>.so``
at the checkout's root, at first use. The hash covers the source, every
header ``csrc/*.cuh`` (a source may include any of them) and the flags, so
an edited source or header is rebuilt and an unchanged tree is reused.
The sources export a plain C interface (no PyTorch headers), which keeps
a build to seconds. ``launch`` calls an entry point on the current stream
of a tensor's card, at the least host cost per call (a wrapper's launch
path is what sets its time where the kernel is short); every entry point
returns ``cudaGetLastError()`` and ``check`` turns a nonzero code into an
exception.

``nvcc`` exists only where a CUDA toolkit is installed, and nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for candidate in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                      "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels need a CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def target_path(name: str, csrc: Path = CSRC,
                build_dir: Path = BUILD_DIR) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: named by a hash of
    the source, of each header in ``csrc`` (name and bytes) and of the
    flags. Needs no ``nvcc``."""
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> dict:
    """Build ``csrc/<name>.cu`` unless it is built already. Returns
    ``{"path", "seconds", "ptxas"}``: ``seconds`` is 0.0 for a library that
    was already built, and ``ptxas`` is the compiler's ``-Xptxas -v``
    report (kept beside the library)."""
    source = CSRC / f"{name}.cu"
    target = target_path(name)
    report = target.with_suffix(".ptxas.txt")
    seconds = 0.0
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        start = time.perf_counter()
        done = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if done.returncode != 0:
            raise RuntimeError(f"kernel build failed: nvcc exited "
                               f"{done.returncode} on {source.name}\n"
                               f"{done.stdout}")
        seconds = time.perf_counter() - start
        report.write_text(done.stdout)
        os.replace(tmp, target)
    return {"path": str(target), "seconds": seconds,
            "ptxas": report.read_text()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        _libraries[name] = lib
    return lib


def launch(entry, device_index: int, *args) -> int:
    """Call the C entry point ``entry(*args, stream)`` with the raw handle of
    the current stream of card ``device_index``; returns its code. The
    launch goes to the calling thread's current card, so a device context
    is entered only when that card is another one. Only CUDA builds of
    torch have the two functions it reads, and CUDA is initialised by the
    time tensors lie on a card."""
    stream = torch._C._cuda_getCurrentRawStream(device_index)
    if device_index == torch._C._cuda_getDevice():
        return entry(*args, stream)
    with torch.cuda.device(device_index):
        return entry(*args, stream)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a kernel entry point of ``lib`` returned a CUDA error code.
    Every source exports ``rtt_cuda_error_string`` for the message."""
    if code != 0:
        lib.rtt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rtt_cuda_error_string.restype = ctypes.c_char_p
        message = lib.rtt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({message})")
