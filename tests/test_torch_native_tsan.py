"""The port's native node store (``ray_tpu_torch/_native/node_store.cpp``)
under ThreadSanitizer, as tests/test_native_tsan.py holds the JAX
package's.

The store is compiled with ``-fsanitize=thread`` together with the
reference's stress driver, tests/native_tsan_stress.cpp (read as a
source file, shared: colliding keys, reseals, chunked reads, frees,
owner sweeps and stats from 8 threads); a data race in the store's
locking fails the test through TSan's report and a nonzero exit. Marked
``slow`` exactly as the reference marks its own (a sanitizer build and
the stress run take minutes on a busy box), and skipped where g++ or its
TSan runtime is missing. The binary is built under the test's temporary
directory.
"""

import os
import shutil
import subprocess
import sys
import tempfile

import pytest

_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_DIR)
_SOURCES = [
    os.path.join(_DIR, "native_tsan_stress.cpp"),
    os.path.join(_REPO, "ray_tpu_torch", "_native", "node_store.cpp"),
]


def _tsan_available() -> bool:
    """Whether -fsanitize=thread links and runs here (g++ may lack libtsan,
    or the runtime may refuse the kernel's address layout)."""
    with tempfile.TemporaryDirectory() as tmp:
        probe_src = os.path.join(tmp, "probe.cpp")
        probe_bin = os.path.join(tmp, "probe")
        with open(probe_src, "w") as f:
            f.write("int main() { return 0; }\n")
        try:
            build = subprocess.run(
                ["g++", "-fsanitize=thread", probe_src, "-o", probe_bin,
                 "-lpthread"], capture_output=True, timeout=60)
            if build.returncode != 0:
                return False
            return subprocess.run([probe_bin], capture_output=True,
                                  timeout=60).returncode == 0
        except (OSError, subprocess.TimeoutExpired):
            return False


@pytest.mark.slow
@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_node_store_is_race_free_under_tsan(tmp_path):
    if not _tsan_available():
        pytest.skip("no working ThreadSanitizer runtime on this box")
    binary = str(tmp_path / "native_tsan_stress")
    build = subprocess.run(
        ["g++", "-O1", "-g", "-fsanitize=thread", *_SOURCES, "-o", binary,
         "-lpthread"], capture_output=True, text=True, timeout=180)
    assert build.returncode == 0, build.stderr[-2000:]
    proc = subprocess.run(
        [binary, str(tmp_path / "spill")], capture_output=True, text=True,
        timeout=300,
        env={**os.environ, "TSAN_OPTIONS": "halt_on_error=0 exitcode=66"})
    sys.stdout.write(proc.stdout[-500:])
    assert "ThreadSanitizer" not in proc.stderr, proc.stderr[-3000:]
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-1000:])
    assert "TSAN-STRESS-OK" in proc.stdout
