"""The ranks of ``tests/test_torch_collective.py``: 8 gloo processes on
the CPU, each running ``util/collective/nccl.py``'s host helpers and
in-SPMD primitives on the same inputs. This module imports torch and
the port only (never JAX): the test spawns its cases through
``torch_parallel_ranks.start_ranks`` and keeps the JAX oracle in its own
process.
"""

from __future__ import annotations

import torch

from torch_parallel_ranks import _np, _t


def _mesh():
    from ray_tpu_torch.util.collective import nccl

    return nccl.default_mesh(axis_name="x", device="cpu")


def case_helpers(inputs) -> dict:
    """The four host helpers on the reference test's inputs and on
    random integer-valued ones."""
    from ray_tpu_torch.util.collective import nccl

    mesh = _mesh()
    out = {}
    for name, x in inputs["helpers"].items():
        fn = getattr(nccl, name.split(":")[0])
        out[f"helper_{name}"] = fn(x, mesh, "x")
    out["helper_device_ring_shift:3"] = nccl.device_ring_shift(
        inputs["helpers"]["device_ring_shift"], mesh, "x", shift=3)
    return out


def _ops():
    from ray_tpu_torch.util.collective import nccl

    ring = [(i, (i + 1) % 8) for i in range(8)]
    return {
        "psum": lambda s: nccl.psum(s, "x"),
        "pmean": lambda s: nccl.pmean(s, "x"),
        "pmax": lambda s: nccl.pmax(s, "x"),
        "pmin": lambda s: nccl.pmin(s, "x"),
        "all_gather": lambda s: nccl.all_gather(s, "x"),
        "all_gather_tiled_1": lambda s: nccl.all_gather(s, "x", axis=1,
                                                        tiled=True),
        "ppermute_ring": lambda s: nccl.ppermute(s, "x", ring),
        "ppermute_partial": lambda s: nccl.ppermute(s, "x",
                                                    [(0, 3), (5, 1)]),
        "all_to_all_tiled": lambda s: nccl.all_to_all(s, "x", 1, 0,
                                                      tiled=True),
        "all_to_all": lambda s: nccl.all_to_all(s, "x", 1, 0),
        "axis_index": lambda s: torch.full((1,), nccl.axis_index("x")),
    }


# The gradients compared with JAX's. Untiled all_to_all's is not: JAX's
# own VJP of it fails at these shapes (jax 0.9.0: a cotangent of the
# output's shape where the input's is expected). It is held instead
# against the gradient of the tiled form (the untiled output is the
# tiled one reshaped) and against finite differences.
DIFFERENTIABLE = ("psum", "pmean", "all_gather", "all_gather_tiled_1",
                  "ppermute_ring", "ppermute_partial", "all_to_all_tiled")


def _untiled_all_to_all_grads(x, w) -> dict:
    """The gradient of sum(all_to_all(x) * w) summed over the ranks, for
    the untiled all_to_all(x, "x", 1, 0): by autograd, through the tiled
    form with w reshaped to its output, and by finite differences of the
    global sum, one element of one rank at a time (the map is linear and
    the values small integers, so each difference is exact at f32).
    Needs the ambient mesh."""
    import torch.distributed as dist

    ops = _ops()
    rank = dist.get_rank()
    leaf = x.clone().requires_grad_(True)
    (ops["all_to_all"](leaf) * w).sum().backward()
    tiled_leaf = x.clone().requires_grad_(True)
    tiled = ops["all_to_all_tiled"](tiled_leaf)
    (tiled * w.reshape(tiled.shape)).sum().backward()

    def global_sum(v):
        total = (ops["all_to_all"](v) * w).sum()
        dist.all_reduce(total)
        return total

    with torch.no_grad():
        base = global_sum(x)
        fd = torch.zeros_like(x)
        for owner in range(dist.get_world_size()):
            for i in range(x.numel()):
                bumped = x.clone()
                if owner == rank:
                    bumped.view(-1)[i] += 1.0
                diff = global_sum(bumped) - base
                if owner == rank:
                    fd.view(-1)[i] = diff
        same_forward = torch.equal(ops["all_to_all"](x).reshape(tiled.shape),
                                   tiled.detach())
    return {"grad_all_to_all": _np(leaf.grad),
            "grad_all_to_all_via_tiled": _np(tiled_leaf.grad),
            "grad_all_to_all_fd": _np(fd),
            "all_to_all_is_tiled_reshaped": bool(same_forward)}


def case_primitives(inputs) -> dict:
    """Each primitive on this rank's shard of x under the ambient mesh
    (its output is this rank's block of the global result), and the
    gradient of sum(out * w) for the differentiable ones."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel.mesh import set_mesh

    mesh = _mesh()
    rank = dist.get_rank()
    x = _t(inputs["x"]).chunk(8)[rank]
    out = {}
    with set_mesh(mesh):
        for name, fn in _ops().items():
            out[f"op_{name}"] = _np(fn(x))
        for name in DIFFERENTIABLE:
            leaf = x.clone().requires_grad_(True)
            y = _ops()[name](leaf)
            w = _t(inputs["w"][name]).chunk(8)[rank]
            (y * w).sum().backward()
            out[f"grad_{name}"] = _np(leaf.grad)
        out.update(_untiled_all_to_all_grads(
            x, _t(inputs["w"]["all_to_all"]).chunk(8)[rank]))
    return out


def case_errors(inputs) -> dict:
    """A primitive outside any mesh, pmax's backward, a partial mesh."""
    from ray_tpu_torch.util.collective import nccl

    out = {}
    try:
        nccl.psum(torch.ones(2), "x")
    except NameError as exc:
        out["unbound"] = str(exc)
    from ray_tpu_torch.parallel.mesh import set_mesh

    with set_mesh(_mesh()):
        leaf = torch.ones(2, requires_grad=True)
        try:
            nccl.pmax(leaf, "x").sum().backward()
        except NotImplementedError as exc:
            out["pmax_grad"] = str(exc)
    try:
        nccl.default_mesh(4, device="cpu")
    except ValueError as exc:
        out["partial_mesh"] = str(exc)
    return out


CASES = (case_helpers, case_primitives, case_errors)
