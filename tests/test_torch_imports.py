"""The port stands alone: no module of ``ray_tpu_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package, and its entry points
never fall back to the CPU on their own."""

import ast
import importlib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "ray_tpu")


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


def test_kernel_wrappers_reject_cpu_tensors():
    fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    before = dict(fa.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_fwd_kernel(q, q, q)
    lse = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dq_kernel(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_bwd_dkv_kernel(q, q, q, q, lse, q)
    assert fa.launches == before
