"""The port's library APIs from tests/test_parity_misc.py against the
JAX package's: each case runs once through ``ray_tpu`` and once through
``ray_tpu_torch`` on a fresh local runtime and returns a plain record.
The data preprocessor cases of that file are in tests/test_torch_data.py.
"""

import importlib

import pytest

import ray_tpu
import ray_tpu_torch


@pytest.fixture
def both_runtimes():
    """Run ``scenario(pkg, experimental)`` on each package's runtime."""

    def run(scenario) -> dict:
        records = {}
        for pkg in (ray_tpu, ray_tpu_torch):
            pkg.shutdown()
            pkg.init(num_cpus=8)
            try:
                records[pkg.__name__] = scenario(
                    pkg, importlib.import_module(
                        f"{pkg.__name__}.experimental"))
            finally:
                pkg.shutdown()
        return records

    return run


def internal_kv(pkg, experimental):
    experimental.internal_kv_put(b"cfg", b"v1")
    return [experimental.internal_kv_get(b"cfg"),
            experimental.internal_kv_exists(b"cfg"),
            b"cfg" in experimental.internal_kv_list(b"c"),
            experimental.internal_kv_del(b"cfg"),
            experimental.internal_kv_get(b"cfg")]


def test_experimental_internal_kv(both_runtimes):
    records = both_runtimes(internal_kv)
    assert records["ray_tpu"] == records["ray_tpu_torch"] == [
        b"v1", True, True, True, None]
