"""The port's mesh and sharding rules against ``ray_tpu.parallel``.

The pure functions case by case against the JAX package's, compared as
tuples: ``MeshConfig.resolved`` (the wildcard and its errors),
``logical_to_spec`` (the default rules and the no-double-use rule, a
``PartitionSpec`` read as a tuple), ``infer_param_logical_axes`` on the
Llama tree and on a made-up tree, and ``param_logical_axes``. Then what
the port adds: ``placements`` from a spec (an axis of size 1 is not a
mesh dim and shards nothing; a tuple out of the mesh's order raises), and
the mesh, the ambient mesh and the placement of params and batches in a
world of one on gloo, which the fixture brings up and tears down.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu.models import llama as jax_llama
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import mesh, sharding
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshConfig


def _spec(pspec) -> tuple:
    """A JAX PartitionSpec as the port's plain tuple."""
    return tuple(pspec)


def test_axis_order_and_rules_are_the_reference_s():
    assert mesh.AXIS_ORDER == jax_mesh.AXIS_ORDER
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    assert sharding.rules_dict() == jax_sharding.rules_dict()
    custom = (("batch", "dp"), ("embed", None))
    assert sharding.rules_dict(custom) == jax_sharding.rules_dict(custom)


@pytest.mark.parametrize("sizes,devices", [
    ({"tp": 2, "dp": -1}, 8),
    ({"fsdp": -1}, 4),
    ({"dp": 2, "fsdp": 2, "tp": 2}, 8),
    ({"sp": 4, "dp": 2}, 8),
    ({}, 1),
])
def test_mesh_config_resolved_matches_jax(sizes, devices):
    got = MeshConfig(**sizes).resolved(devices)
    want = jax_mesh.MeshConfig(**sizes).resolved(devices)
    assert got.axis_sizes == want.axis_sizes


@pytest.mark.parametrize("sizes,devices", [
    ({"dp": 3, "tp": 2}, 8),          # multiplies to 6, not 8
    ({"dp": -1, "tp": -1}, 8),        # two wildcards
    ({"tp": 3, "dp": -1}, 8),         # 8 not divisible by 3
])
def test_mesh_config_errors_match_jax(sizes, devices):
    with pytest.raises(ValueError) as want:
        jax_mesh.MeshConfig(**sizes).resolved(devices)
    with pytest.raises(ValueError) as got:
        MeshConfig(**sizes).resolved(devices)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("logical", [
    ("batch", "embed", "heads"),      # embed's fsdp is used by batch
    ("batch", "embed"),
    ("batch", "sequence", "embed"),
    ("embed", "batch"),               # embed takes fsdp first
    ("vocab", "embed"),
    (None, "embed", "kv_heads", None),
    ("mlp", "heads"),                 # heads finds tp used
    ("expert", "stage", "norm", "head_dim", "unknown"),
])
def test_logical_to_spec_matches_jax(logical):
    assert sharding.logical_to_spec(logical) == _spec(
        jax_sharding.logical_to_spec(logical))


def test_logical_to_spec_custom_rules_match_jax():
    rules = (("batch", ("fsdp", "dp")), ("embed", ("tp", "fsdp")))
    for logical in (("batch", "embed"), ("embed", "batch")):
        assert sharding.logical_to_spec(logical, rules) == _spec(
            jax_sharding.logical_to_spec(logical, rules))


def test_infer_param_logical_axes_on_llama_matches_jax():
    cfg = llama.LlamaConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jax_params = jax_llama.init_params(jax_llama.LlamaConfig.tiny(),
                                       jax.random.PRNGKey(0))
    assert sharding.infer_param_logical_axes(params) == \
        jax_sharding.infer_param_logical_axes(jax_params)


def test_infer_param_logical_axes_on_a_made_up_tree_matches_jax():
    shapes = {"bias": (8,), "scalar": (), "token_embed": (32, 8),
              "vocab_proj": (8, 32), "o_proj": (16, 8), "down": (16, 8),
              "up": (8, 16), "qkv": (8, 4, 2), "conv": (2, 2, 2, 2),
              "deep": {"out_proj": (4, 4), "w5": (1, 1, 1, 1, 1)}}

    def build(shapes, make):
        return {k: build(v, make) if isinstance(v, dict) else make(v)
                for k, v in shapes.items()}

    got = sharding.infer_param_logical_axes(build(shapes, torch.zeros))
    want = jax_sharding.infer_param_logical_axes(build(shapes, np.zeros))
    assert got == want
    assert got["token_embed"] == ("vocab", "embed")
    assert got["deep"]["out_proj"] == ("mlp", "embed")


def test_param_logical_axes_match_jax_and_the_tree():
    cfg = llama.LlamaConfig.tiny()
    got = llama.param_logical_axes(cfg)
    assert got == jax_llama.param_logical_axes(jax_llama.LlamaConfig.tiny())
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def ranks_match(p, axes):
        if isinstance(p, dict):
            assert p.keys() == axes.keys()
            for key in p:
                ranks_match(p[key], axes[key])
        else:
            assert p.dim() == len(axes)

    ranks_match(params, got)


class _FakeMesh:
    """What ``placements`` reads of a DeviceMesh."""

    def __init__(self, *names):
        self.mesh_dim_names, self.ndim = names, len(names)


@pytest.mark.parametrize("names,spec,want", [
    (("dp", "fsdp", "tp"), (("dp", "fsdp"), None, "tp", None),
     [Shard(0), Shard(0), Shard(2)]),
    (("dp", "fsdp", "tp"), ("fsdp", "tp"), [Replicate(), Shard(0), Shard(1)]),
    # sp and tp have size 1, so they are no dims of the mesh.
    (("dp", "fsdp"), (("dp", "fsdp"), "sp", "tp", None),
     [Shard(0), Shard(0)]),
    (("dp",), (None, "embed_free"), "raises"),
    (("dp", "fsdp"), (("fsdp", "dp"),), "raises"),   # out of the mesh order
    (("dp", "sp"), (("sp", "dp"),), "raises"),
    (("dp", "tp"), ("tp", "tp"), "raises"),           # an axis used twice
])
def test_placements_of_a_spec(names, spec, want):
    fake = _FakeMesh(*names)
    if want == "raises":
        with pytest.raises(ValueError):
            sharding.placements(fake, spec)
    else:
        assert sharding.placements(fake, spec) == want


@pytest.fixture
def world_of_one():
    """A default gloo group of one rank in this process, torn down after
    the test."""
    assert not dist.is_initialized()
    from ray_tpu_torch._private.dist import ensure_process_group

    ensure_process_group(torch.device("cpu"))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_build_mesh_in_a_world_of_one(world_of_one):
    m = mesh.build_mesh(MeshConfig(dp=1), device="cpu")
    # No axis is larger than 1: the mesh keeps dp, of size 1.
    assert m.mesh_dim_names == ("dp",) and m.device_type == "cpu"
    assert [mesh.mesh_axis_size(m, a) for a in AXIS_ORDER] == [1] * 6
    assert mesh.data_axes(m) == ()
    single = mesh.single_axis_mesh("tp", device="cpu")
    assert single.mesh_dim_names == ("tp",) and single.size() == 1
    with pytest.raises(ValueError, match="multiply to 2"):
        mesh.build_mesh(MeshConfig(dp=2), device="cpu")


def test_set_mesh_is_the_ambient_mesh(world_of_one):
    m = mesh.build_mesh(device="cpu")
    assert mesh.ambient_mesh() is None
    with mesh.set_mesh(m):
        assert mesh.ambient_mesh() is m
        with mesh.set_mesh(None):
            assert mesh.ambient_mesh() is m
    assert mesh.ambient_mesh() is None


def test_shard_params_and_shardings_in_a_world_of_one(world_of_one):
    m = mesh.build_mesh(device="cpu")
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    jax_params = jax_llama.init_params(jax_llama.LlamaConfig.tiny(),
                                       jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jax_params), "cpu")
    axes = llama.param_logical_axes(cfg)
    placed = sharding.shard_params(params, m, axes)
    shardings = sharding.tree_shardings(m, axes)
    for name in ("wq", "w_down"):
        leaf = placed["layers"][name]
        assert isinstance(leaf, DTensor)
        assert list(leaf.placements) == shardings["layers"][name].placements
        torch.testing.assert_close(leaf.full_tensor(),
                                   params["layers"][name], rtol=0, atol=0)
    # The batch's dp over a mesh of (dp,) of size 1.
    assert sharding.named_sharding(m, "batch", "embed").placements == \
        [Shard(0)]
    x = sharding.constrain(torch.ones(4, 8), m, None, "embed")
    assert isinstance(x, DTensor) and list(x.placements) == [Replicate()]


@pytest.mark.parametrize("attention,remat", [("flash", "dots"),
                                             ("plain", "full")])
def test_mesh_train_step_in_a_world_of_one_matches_the_plain_step(
        world_of_one, attention, remat):
    """chip_smoke's mesh_train at the tiny size: params placed on a mesh
    of one rank by create_train_state, the batch by shard_batch, remat on;
    3 steps' losses and grad norms against the same steps without a mesh
    (__graft_entry__'s bound, rtol 2e-3, atol 1e-4), and the params still
    DTensors after."""
    from ray_tpu_torch._private.tree import tree_leaves
    from ray_tpu_torch.parallel import train_step

    m = mesh.build_mesh(MeshConfig(dp=1), device="cpu")
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32,
                              attention=attention, remat=True,
                              remat_policy=remat, num_kv_heads=2)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}

    def loss(p, b):
        return llama.loss_fn(p, b["tokens"], b["targets"], cfg)

    trajectories = []
    for on_mesh in (False, True):
        opt = train_step.default_optimizer(learning_rate=1e-2,
                                           warmup_steps=0, total_steps=10)
        if on_mesh:
            state = train_step.create_train_state(
                params, opt, m, llama.param_logical_axes(cfg))
            placed = train_step.shard_batch(batch, m)
        else:
            state = train_step.create_train_state(params, opt, device="cpu")
            placed = train_step.place_batch(batch, "cpu")
        step = train_step.build_train_step(loss, opt)
        out = []
        for _ in range(3):
            state, metrics = step(state, placed)
            out.append((metrics["loss"].item(), metrics["grad_norm"].item()))
        trajectories.append(out)
    np.testing.assert_allclose(trajectories[1], trajectories[0], rtol=2e-3,
                               atol=1e-4)
    assert all(isinstance(p, DTensor) for p in tree_leaves(state.params))
    assert trajectories[1][2][0] < trajectories[1][0][0]
