"""The port stands alone: no module of ``ray_tpu_torch``, not
``chip_smoke.py``, ``rmsnorm_launch_cost.py`` or
``same_host_plane_compare.py`` imports JAX, the
JAX package or ``cloudpickle`` (the port pickles code itself), and its
entry points never fall back to the CPU on their own."""

import ast
import dataclasses
import importlib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "rmsnorm_launch_cost.py",
    ROOT / "same_host_plane_compare.py",
    # The ranks that tests/test_torch_parallel.py and
    # tests/test_torch_pipeline.py spawn import torch only.
    ROOT / "tests" / "torch_parallel_ranks.py",
    ROOT / "tests" / "torch_pipeline_ranks.py",
    ROOT / "tests" / "torch_collective_ranks.py"]
MESH_MODULES = ("_private/dist.py", "parallel/mesh.py", "parallel/sharding.py",
                "parallel/ring_attention.py")
MOE_PIPELINE_MODULES = ("models/moe.py", "parallel/pipeline.py")
FORBIDDEN = ("jax", "ray_tpu")
# The collective API and the Train library, imported in a fresh
# interpreter where importing jax or ray_tpu raises.
TRAIN_COLLECTIVE_MODULES = (
    "ray_tpu_torch.util.collective", "ray_tpu_torch.util.collective.store",
    "ray_tpu_torch.util.collective.collective",
    "ray_tpu_torch.util.collective.nccl", "ray_tpu_torch.models.mlp",
    "ray_tpu_torch.train", "ray_tpu_torch.train.config",
    "ray_tpu_torch.train.checkpoint", "ray_tpu_torch.train.session",
    "ray_tpu_torch.train.worker_group", "ray_tpu_torch.train.trainer",
    "ray_tpu_torch.train.torch", "ray_tpu_torch.train.huggingface")
# The process runtime: worker processes, their transport and the client
# server, imported where importing jax, ray_tpu or cloudpickle raises.
PROCESS_MODULES = (
    "ray_tpu_torch._private.serialization", "ray_tpu_torch._private.shm_store",
    "ray_tpu_torch._private.rpc", "ray_tpu_torch._private.worker_client",
    "ray_tpu_torch._private.log_monitor",
    "ray_tpu_torch._private.worker_factory",
    "ray_tpu_torch._private.worker_pool", "ray_tpu_torch.util.client",
    "ray_tpu_torch.util.client.server", "ray_tpu_torch._private.worker")
# The managed spill tier, lineage recovery and the memory monitor.
STORE_RECOVERY_MODULES = (
    "ray_tpu_torch._private.spill_manager",
    "ray_tpu_torch._private.recovery",
    "ray_tpu_torch._private.memory_monitor")
# The node layer: the head, node daemons, remote actors and the cluster.
NODE_MODULES = (
    "ray_tpu_torch._private.gcs", "ray_tpu_torch._private.gcs_pubsub",
    "ray_tpu_torch._private.gcs_server", "ray_tpu_torch._private.node",
    "ray_tpu_torch._private.node_executor",
    "ray_tpu_torch._private.remote_actor",
    "ray_tpu_torch._private.runtime_env_packaging",
    "ray_tpu_torch._private.scheduler", "ray_tpu_torch.cluster_utils")
# The durable head's persistence, the chaos sites it wires and the
# internal KV.
DURABLE_HEAD_MODULES = (
    "ray_tpu_torch._private.gcs_persistence", "ray_tpu_torch._private.chaos",
    "ray_tpu_torch.experimental", "ray_tpu_torch.experimental.internal_kv")
# Named actors across drivers, borrowed refs and the owner sweep.
DIRECTORY_MODULES = (
    "ray_tpu_torch.actor", "ray_tpu_torch._private.worker",
    "ray_tpu_torch._private.object_ref", "ray_tpu_torch._private.config",
    "ray_tpu_torch._private.node_executor",
    "ray_tpu_torch._private.gcs_pubsub", "ray_tpu_torch.util.client.server")
# The sharded head and the observability plane.
OBSERVABILITY_MODULES = (
    "ray_tpu_torch._private.gcs_shard",
    "ray_tpu_torch._private.flight_recorder",
    "ray_tpu_torch._private.perf_plane",
    "ray_tpu_torch._private.metrics_history",
    "ray_tpu_torch._private.metrics_agent", "ray_tpu_torch.util.metrics",
    "ray_tpu_torch.serve.llm_engine.engine")
# The pipelined task path: the transport, the store's grouped seal, the
# worker leases, the batch RPC and its fused runs, batched dispatch and
# the driver's submit ring.
TASK_PIPELINE_MODULES = (
    "ray_tpu_torch._private.rpc", "ray_tpu_torch._private.object_store",
    "ray_tpu_torch._private.worker_pool",
    "ray_tpu_torch._private.node_executor",
    "ray_tpu_torch._private.scheduler", "ray_tpu_torch._private.worker",
    "ray_tpu_torch._private.config")
# The data package: every module, imported where importing jax, ray_tpu
# or cloudpickle raises.
DATA_MODULES = tuple(
    "ray_tpu_torch.data" + ("" if p.stem == "__init__" else "." + p.stem)
    for p in sorted((ROOT / "ray_tpu_torch" / "data").glob("*.py")))
# What a user of the runtime, Train and Serve imports: none of it may
# need pyarrow or pandas (the data package alone does).
NO_ARROW_MODULES = ("ray_tpu_torch", "ray_tpu_torch.train",
                    "ray_tpu_torch.serve", "ray_tpu_torch.parallel",
                    "ray_tpu_torch.util")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_ray_tpu(path):
    bad = [name for name in _imported_modules(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_cloudpickle(path):
    bad = [name for name in _imported_modules(path)
           if name.split(".")[0] == "cloudpickle"]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _import_blocked(modules, blocked, watched=None) -> str:
    """Import ``modules`` in a fresh interpreter where importing any of
    ``blocked`` raises; the packages of ``watched`` (``blocked`` by
    default) loaded after, as printed."""
    import subprocess
    import sys

    code = "\n".join([
        "import importlib, sys",
        "class Block:",
        "    def find_spec(self, name, path=None, target=None):",
        f"        if name.split('.')[0] in {blocked!r}:",
        "            raise ImportError('blocked: ' + name)",
        "sys.meta_path.insert(0, Block())",
        f"for name in {modules!r}:",
        "    importlib.import_module(name)",
        "print(sorted(m for m in sys.modules",
        f"             if m.split('.')[0] in {watched or blocked!r}))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_process_modules_import_without_jax_ray_tpu_or_cloudpickle():
    assert _import_blocked(PROCESS_MODULES,
                           FORBIDDEN + ("cloudpickle",)) == "[]"


def test_store_recovery_modules_import_without_jax_ray_tpu_or_cloudpickle():
    checked = {str(p.relative_to(ROOT / "ray_tpu_torch"))
               for p in PORT_FILES if "ray_tpu_torch" in p.parts}
    assert {"_private/spill_manager.py", "_private/recovery.py",
            "_private/memory_monitor.py"} <= checked
    assert _import_blocked(STORE_RECOVERY_MODULES,
                           FORBIDDEN + ("cloudpickle",)) == "[]"


def test_node_modules_import_without_jax_ray_tpu_or_cloudpickle():
    checked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {f"ray_tpu_torch/{m.split('.', 1)[1].replace('.', '/')}.py"
            for m in NODE_MODULES} <= checked
    assert _import_blocked(NODE_MODULES,
                           FORBIDDEN + ("cloudpickle",)) == "[]"


def test_durable_head_modules_import_without_jax_ray_tpu_or_cloudpickle():
    checked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"ray_tpu_torch/_private/gcs_persistence.py",
            "ray_tpu_torch/_private/chaos.py",
            "ray_tpu_torch/experimental/__init__.py",
            "ray_tpu_torch/experimental/internal_kv.py"} <= checked
    assert _import_blocked(DURABLE_HEAD_MODULES,
                           FORBIDDEN + ("cloudpickle",)) == "[]"


def test_directory_modules_import_without_jax_ray_tpu_or_cloudpickle():
    assert _import_blocked(DIRECTORY_MODULES,
                           FORBIDDEN + ("cloudpickle",)) == "[]"
    from ray_tpu_torch._private.config import GLOBAL_CONFIG
    from ray_tpu_torch._private.gcs_pubsub import GcsPublisher
    from ray_tpu_torch._private.object_ref import collect_reduced_refs
    from ray_tpu_torch.actor import ForeignActorHandle

    assert callable(GcsPublisher) and callable(collect_reduced_refs)
    assert ForeignActorHandle("127.0.0.1:1", "ab" * 16) \
        == ForeignActorHandle("127.0.0.1:1", "ab" * 16, "Other")
    assert GLOBAL_CONFIG.get("owner_sweep_period_ms") > 0
    assert GLOBAL_CONFIG.get("owner_dead_grace_s") > 0


def test_observability_modules_import_without_jax_ray_tpu_or_cloudpickle():
    checked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"ray_tpu_torch/_private/gcs_shard.py",
            "ray_tpu_torch/_private/flight_recorder.py",
            "ray_tpu_torch/_private/metrics_agent.py",
            "ray_tpu_torch/util/metrics.py"} <= checked
    assert _import_blocked(OBSERVABILITY_MODULES,
                           FORBIDDEN + ("cloudpickle",)) == "[]"
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    assert GLOBAL_CONFIG.get("gcs_shards") == 1
    assert GLOBAL_CONFIG.get("perf_plane") is True
    assert GLOBAL_CONFIG.get("metrics_history") is True


def test_task_pipeline_modules_import_without_jax_ray_tpu_or_cloudpickle():
    """The modules of the pipelined task path, where importing jax,
    ray_tpu or cloudpickle raises; its knobs are armed by default."""
    assert _import_blocked(TASK_PIPELINE_MODULES,
                           FORBIDDEN + ("cloudpickle",)) == "[]"
    from ray_tpu_torch._private import node_executor
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    assert GLOBAL_CONFIG.get("submit_pipeline") is True
    assert GLOBAL_CONFIG.get("fused_execution") is True
    assert node_executor.FUSED_ON is True
    assert callable(node_executor.NodeExecutorService.execute_task_batch)


def test_same_host_plane_imports_without_jax_ray_tpu_or_cloudpickle():
    """The same-host plane's own module, and the spill tier that takes
    its liveness probe, where importing jax, ray_tpu or cloudpickle
    raises; its three knobs carry the reference's defaults."""
    checked = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert "ray_tpu_torch/_private/same_host.py" in checked
    assert _import_blocked(("ray_tpu_torch._private.same_host",
                            "ray_tpu_torch._private.spill_manager"),
                           FORBIDDEN + ("cloudpickle",)) == "[]"
    from ray_tpu_torch._private import same_host, spill_manager
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    assert spill_manager.pid_is_dead is same_host.pid_is_dead
    assert (GLOBAL_CONFIG.get("same_host_plane"),
            GLOBAL_CONFIG.get("same_host_map_min_kb"),
            GLOBAL_CONFIG.get("same_host_pin_ttl_s")) == (True, 1024, 30.0)


def test_a_node_daemon_starts_without_jax_ray_tpu_or_cloudpickle():
    """A daemon process (what ``Cluster.add_node`` starts) imports its
    whole stack where importing jax, ray_tpu or cloudpickle raises, and
    serves until it is stopped."""
    import subprocess
    import sys

    code = "\n".join([
        "import signal, sys, threading, time",
        "class Block:",
        "    def find_spec(self, name, path=None, target=None):",
        "        if name.split('.')[0] in ('jax', 'ray_tpu', 'cloudpickle'):",
        "            raise ImportError('blocked: ' + name)",
        "sys.meta_path.insert(0, Block())",
        "from ray_tpu_torch._private.gcs_server import GcsServer",
        "from ray_tpu_torch._private import node",
        "server = GcsServer().start()",
        "def stop_once_registered():",
        "    while not any(n['alive'] for n in server._list_nodes()):",
        "        time.sleep(0.05)",
        "    signal.raise_signal(signal.SIGTERM)",
        "threading.Thread(target=stop_once_registered, daemon=True).start()",
        "node.run_worker(server.address, {'CPU': 1.0}, pool_size=1)",
        "nodes = server._list_nodes()",
        "server.stop()",
        "print(len(nodes), nodes[0]['alive'], sorted(m for m in sys.modules",
        "      if m.split('.')[0] in ('jax', 'ray_tpu', 'cloudpickle')))",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1 False []"


def test_native_layer_builds_from_the_ports_sources_into_its_build_dir():
    """The library the port loads is built from
    ``ray_tpu_torch/_native/*.cpp`` into ``build/ray_tpu_torch/`` (named by
    their hash, linked ``-Wl,-Bsymbolic``), and once the arena, the KV
    engine and the node store have been used in a fresh interpreter where
    importing jax, ray_tpu or cloudpickle raises, ``ray_tpu`` is still
    absent from ``sys.modules``."""
    import subprocess
    import sys

    from ray_tpu_torch import _native

    assert sorted(_native.SOURCES) == sorted(
        (ROOT / "ray_tpu_torch" / "_native").glob("*.cpp"))
    assert _native.library_path().parent == ROOT / "build" / "ray_tpu_torch"
    assert "-Wl,-Bsymbolic" in _native.CXX_FLAGS
    code = "\n".join([
        "import os, sys",
        "class Block:",
        "    def find_spec(self, name, path=None, target=None):",
        "        if name.split('.')[0] in ('jax', 'ray_tpu', 'cloudpickle'):",
        "            raise ImportError('blocked: ' + name)",
        "sys.meta_path.insert(0, Block())",
        "from ray_tpu_torch import _native",
        "from ray_tpu_torch._private.arena_store import ArenaStore",
        "from ray_tpu_torch._private.gcs_kv_native import NativeKVStore",
        "from ray_tpu_torch._private.node_store_native import "
        "NativeNodeObjectStore",
        "lib = _native.load()",
        "arena = ArenaStore.create(f'/rtt_imports_{os.getpid()}', 1 << 20)",
        "arena.put_bytes(b'k' * 16, [b'v'])",
        "assert arena.get_bytes(b'k' * 16) == b'v'",
        "arena.close()",
        "kv = NativeKVStore(lib)",
        "kv.put(b'k', b'v')",
        "assert kv.get(b'k') == b'v'",
        "store = NativeNodeObjectStore(lib, spill_dir=sys.argv[1])",
        "store.put(b'k' * 16, b'v')",
        "assert store.get(b'k' * 16) == b'v'",
        "print(lib._name)",
        "print(sorted(m for m in sys.modules",
        "      if m.split('.')[0] in ('jax', 'ray_tpu', 'cloudpickle')))",
    ])
    import tempfile

    with tempfile.TemporaryDirectory() as spill_dir:
        out = subprocess.run([sys.executable, "-c", code, spill_dir],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
    assert out.returncode == 0, out.stderr
    loaded, modules = out.stdout.strip().splitlines()
    assert loaded == str(_native.library_path())
    assert modules == "[]"


@pytest.mark.parametrize("fault", ["timeout", "no_compiler_binary"])
def test_native_build_that_cannot_finish_raises_native_load_error(
        fault, monkeypatch, tmp_path):
    """A compiler run past its time limit, or one that cannot be started,
    raises ``NativeLoadError`` (with the output so far), as a failed
    build does, and leaves no temporary file behind."""
    import subprocess

    from ray_tpu_torch import _native

    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_native, "library_path",
                        lambda: tmp_path / "libnative-test.so")
    if fault == "timeout":
        def run(cmd, **kwargs):
            raise subprocess.TimeoutExpired(cmd, kwargs["timeout"],
                                            output="partial output")

        monkeypatch.setattr(_native.subprocess, "run", run)
        expected = "partial output"
    else:
        monkeypatch.setattr(_native.shutil, "which",
                            lambda name: str(tmp_path / "missing-g++"))
        expected = "cannot run"
    with pytest.raises(_native.NativeLoadError, match=expected):
        _native.build()
    assert sorted(p.name for p in tmp_path.iterdir()) == [".native.lock"]


def test_data_modules_import_without_jax_ray_tpu_or_cloudpickle():
    assert len(DATA_MODULES) == 12  # the 11 ported modules, _device_feed
    assert _import_blocked(DATA_MODULES,
                           FORBIDDEN + ("cloudpickle",)) == "[]"


def test_runtime_train_and_serve_leave_pyarrow_and_pandas_unimported():
    assert _import_blocked(NO_ARROW_MODULES, (),
                           ("pyarrow", "pandas")) == "[]"


def test_the_device_feed_imports_with_pyarrow_blocked():
    assert _import_blocked(("ray_tpu_torch.data._device_feed",),
                           ("pyarrow", "pandas")) == "[]"


def test_the_device_feed_raises_without_a_card(monkeypatch):
    """No card: ``iter_device_batches`` raises at the call unless it asks
    for the CPU, and never falls back to the CPU on its own."""
    import ray_tpu_torch
    from ray_tpu_torch import data

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        ds = data.range(8)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ds.iter_device_batches(batch_size=4)
        batches = list(ds.iter_device_batches(batch_size=4, device="cpu"))
        assert [b["id"].device.type for b in batches] == ["cpu", "cpu"]
    finally:
        ray_tpu_torch.shutdown()


def test_the_mesh_modules_are_checked():
    checked = {str(p.relative_to(ROOT / "ray_tpu_torch"))
               for p in PORT_FILES if "ray_tpu_torch" in p.parts}
    assert set(MESH_MODULES) <= checked


def test_the_moe_and_pipeline_modules_are_checked():
    checked = {str(p.relative_to(ROOT / "ray_tpu_torch"))
               for p in PORT_FILES if "ray_tpu_torch" in p.parts}
    assert set(MOE_PIPELINE_MODULES) <= checked
    assert ROOT / "tests" / "torch_pipeline_ranks.py" in PORT_FILES


def test_moe_init_raises_without_a_card(monkeypatch):
    from ray_tpu_torch.models import llama, moe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        moe.init_moe_params(torch.Generator(), 8, 16, 2, 1)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), num_experts=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama.init_params(cfg, torch.Generator())


def test_mesh_entry_points_raise_without_a_card(monkeypatch):
    """No card: the mesh raises before any process group exists, and
    never falls back to gloo on the CPU."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import build_mesh, single_axis_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    for entry in (build_mesh, single_axis_mesh):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    assert not dist.is_initialized()


def test_forbidden_matches_only_the_jax_packages():
    assert _forbidden("jax.numpy") and _forbidden("ray_tpu.ops")
    assert not _forbidden("ray_tpu_torch.ops") and not _forbidden("jaxtyping")


def test_resolve_device_raises_without_a_card(monkeypatch):
    from ray_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.train_step import (
        create_train_state,
        default_optimizer,
        place_batch,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError):
        llama.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError):
        params_from_numpy({"w": [1.0]})
    with pytest.raises(RuntimeError):
        create_train_state({"w": torch.zeros(1)}, default_optimizer())
    with pytest.raises(RuntimeError):
        place_batch({"tokens": [[1]]})


def test_serving_entry_points_raise_without_a_card(monkeypatch):
    """The engine and the server raise before starting a loop thread."""
    import threading

    from ray_tpu_torch.serve.llm_engine import LLMEngine, LLMEngineServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    threads = threading.active_count()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLMEngineServer()
    assert threading.active_count() == threads


def test_serving_a_deployment_raises_without_a_card(monkeypatch):
    """``serve.run`` of an ``LLMEngineServer`` deployment without
    ``device="cpu"`` fails typed at the replica's construction (the
    engine's RuntimeError as the actor error's cause): no replica serves
    on the CPU, and none is started again."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.exceptions import ActorError
    from ray_tpu_torch.serve.llm_engine import LLMEngineServer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        app = serve.deployment(LLMEngineServer).bind()
        with pytest.raises(ActorError) as err:
            serve.run(app, name="llm_app")
        status = serve.status()["llm_app::LLMEngineServer"]
    finally:
        try:
            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
    assert isinstance(err.value.cause, RuntimeError)
    assert "device='cpu'" in str(err.value.cause)
    assert status["status"] == "DEPLOY_FAILED"
    assert status["running_replicas"] == 0


def test_kernel_wrappers_reject_cpu_tensors():
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_fwd_kernel(q, q, q)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dq_kernel(q, q, q, lse, q, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dkv_kernel(q, q, q, lse, q, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_delta_kernel(q, q)
    assert fa.launches == before


def test_rmsnorm_kernel_wrapper_rejects_cpu_tensors():
    fused = importlib.import_module("ray_tpu_torch.ops.fused")
    before = dict(fused.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused.rms_norm_kernel(torch.zeros((4, 64), dtype=torch.bfloat16),
                              torch.ones(64))
    assert fused.launches == before


def test_train_and_collective_modules_import_with_jax_blocked():
    assert _import_blocked(TRAIN_COLLECTIVE_MODULES, FORBIDDEN) == "[]"


def test_train_and_collective_entry_points_raise_without_a_card(
        monkeypatch):
    """No card: the worker's mesh, the MLP's init and the device plane's
    mesh raise, and none falls back to the CPU."""
    import torch.distributed as dist

    from ray_tpu_torch import train
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.util.collective import nccl

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (train.get_mesh, nccl.default_mesh,
                  lambda: mlp.init_params(mlp.MLPConfig(),
                                          torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry()
    assert not dist.is_initialized()
