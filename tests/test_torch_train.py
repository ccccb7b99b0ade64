"""The port's Train library against the JAX package's.

Each mirrored case of tests/test_train.py is a scenario that runs once
through ``ray_tpu`` (``JaxTrainer``) and once through ``ray_tpu_torch``
(``MeshTrainer``), each under its own ``init(num_cpus=8)`` and
``shutdown()``. It returns a plain record (values, exception class
names, resource dicts); the two records must be equal, and equal to what
the mirrored test asserts. The MNIST-style MLP runs the JAX init's
parameters (through numpy) and the same batch through both loops: the
port's per-step losses within rtol 2e-3 / atol 1e-4 of the JAX loop's,
the accuracy above 0.8 in both.

The slice as a whole: the tiny Llama (2 layers, f32, flash attention;
the JAX package's Pallas kernels in interpret mode, the port's plain
versions) trains through ``MeshTrainer`` on ``device="cpu"`` (a world of
one on gloo, the params DTensors) with checkpoints at steps 1, 3 and 5,
one injected failure after step 3 and a resume from step 3's
checkpoint; the same loop runs through ``JaxTrainer`` (8 virtual CPU
devices) on the converted params. Losses and grad norms agree within
rtol 2e-3 / atol 1e-4, and the resumed steps equal an uninterrupted
port run's bitwise.

Where the port deliberately differs (port-only cases at the end):

- ``MeshTrainer`` is the reference's ``JaxTrainer``, its
  ``dist_config`` the reference's ``jax_distributed_config`` (keywords
  of ``init_process_group``, or ``"auto"``);
- ``ScalingConfig`` has ``use_gpu``/``gpus_per_worker`` (a ``GPU``
  demand) for ``use_tpu``/``chips_per_worker``, and refuses
  ``use_process_workers=True`` (process gangs are ROADMAP item 6), as
  ``"auto"`` with more than one thread worker is refused;
- checkpoints of tensors go through ``torch.distributed.checkpoint``
  (no pickle fallback: a failed save raises), plain tensors and
  DTensors round trip bitwise;
- ``prepare_model``'s gradients travel as tensors (bf16 included), and
  the loop runs with multithreaded backward off, so the hooks average on
  the worker's own thread (on ``cuda`` too, where autograd would run
  them on the card's one shared thread); a backward from another thread
  is refused;

tests/test_torch_huggingface.py holds the mirror of the
``TransformersTrainer`` case.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import ray_tpu
import ray_tpu_torch
from ray_tpu import train as jax_train
from ray_tpu_torch import train as port_train

PACKAGES = {"ray_tpu": (ray_tpu, jax_train, jax_train.JaxTrainer),
            "ray_tpu_torch": (ray_tpu_torch, port_train,
                              port_train.MeshTrainer)}
TRAJECTORY_TOL = dict(rtol=2e-3, atol=1e-4)  # __graft_entry__.py:42-44


def _run(scenario, name, tmp_path):
    rt, train, trainer = PACKAGES[name]
    rt.shutdown()
    rt.init(num_cpus=8)
    try:
        return scenario(rt, train, trainer, str(tmp_path / name))
    finally:
        rt.shutdown()


def _both(scenario, tmp_path):
    records = {name: _run(scenario, name, tmp_path) for name in PACKAGES}
    assert records["ray_tpu_torch"] == records["ray_tpu"], records
    return records["ray_tpu_torch"]


@pytest.fixture
def no_process_group():
    """A case that brings up the default group destroys it after, so the
    next test in this process finds none."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------ mirrored: test_train


def test_single_worker_report(tmp_path):
    def scenario(rt, train, trainer, storage):
        def loop(config):
            for i in range(3):
                train.report({"iter": i, "loss": 1.0 / (i + 1)})

        result = trainer(loop,
                         scaling_config=train.ScalingConfig(num_workers=1),
                         run_config=train.RunConfig(storage_path=storage)).fit()
        return (result.error, result.metrics["iter"],
                len(result.metrics_history))

    assert _both(scenario, tmp_path) == (None, 2, 3)


def test_multi_worker_context(tmp_path):
    def scenario(rt, train, trainer, storage):
        def loop(config):
            ctx = train.get_context()
            train.report({"rank": ctx.get_world_rank(),
                          "world": ctx.get_world_size()})

        result = trainer(loop,
                         scaling_config=train.ScalingConfig(num_workers=4),
                         run_config=train.RunConfig(storage_path=storage)).fit()
        return result.error, result.metrics

    assert _both(scenario, tmp_path) == (None, {"rank": 0, "world": 4})


def _mlp_inputs() -> dict:
    """The reference test's params and batch, as numpy."""
    from ray_tpu.models import mlp

    cfg = mlp.MLPConfig(input_dim=16, hidden_dims=(32,), num_classes=4)
    params = jax.tree.map(np.asarray,
                          mlp.init_params(cfg, jax.random.PRNGKey(0)))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (64, 16)))
    return {"params": params, "x": x,
            "y": (x.sum(axis=1) > 0).astype(np.int32) * 2, "steps": 30}


def _jax_mlp_loop(config):
    import optax

    from ray_tpu.models import mlp
    from ray_tpu.parallel.train_step import (
        build_train_step,
        create_train_state,
    )

    params = jax.tree.map(jnp.asarray, config["params"])
    optimizer = optax.adam(1e-2)
    state = create_train_state(params, optimizer)
    step = build_train_step(mlp.loss_fn, optimizer)
    batch = {"x": jnp.asarray(config["x"]), "y": jnp.asarray(config["y"])}
    for i in range(config["steps"]):
        state, metrics = step(state, batch)
        jax_train.report({"loss": float(metrics["loss"]), "step": i})
    acc = float(mlp.accuracy(state.params, batch))
    jax_train.report({"accuracy": acc, "final": True},
                     checkpoint=jax_train.Checkpoint.from_state(state.params))


def _port_mlp_loop(config):
    from ray_tpu_torch.models import mlp
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.train_step import (
        Adam,
        build_train_step,
        create_train_state,
    )

    optimizer = Adam(1e-2)
    state = create_train_state(params_from_numpy(config["params"], "cpu"),
                               optimizer, device="cpu")
    step = build_train_step(mlp.loss_fn, optimizer)
    batch = {"x": torch.tensor(config["x"]), "y": torch.tensor(config["y"])}
    for i in range(config["steps"]):
        state, metrics = step(state, batch)
        port_train.report({"loss": metrics["loss"].item(), "step": i})
    acc = mlp.accuracy(state.params, batch).item()
    port_train.report(
        {"accuracy": acc, "final": True},
        checkpoint=port_train.Checkpoint.from_state(state.params))


def test_mnist_style_mlp_e2e(tmp_path):
    """BASELINE config 2: MLP DataParallelTrainer; loss must fall."""
    inputs = _mlp_inputs()
    loops = {"ray_tpu": _jax_mlp_loop, "ray_tpu_torch": _port_mlp_loop}

    def scenario(rt, train, trainer, storage):
        name = "ray_tpu" if train is jax_train else "ray_tpu_torch"
        result = trainer(
            loops[name], train_loop_config=inputs,
            scaling_config=train.ScalingConfig(num_workers=2),
            run_config=train.RunConfig(storage_path=storage)).fit()
        assert result.error is None, result.error
        losses = [m["loss"] for m in result.metrics_history if "loss" in m]
        return (losses, result.metrics["accuracy"],
                result.checkpoint.to_state())

    runs = {name: _run(scenario, name, tmp_path) for name in PACKAGES}
    (want, want_acc, _), (got, got_acc, restored) = runs.values()
    assert len(got) == len(want) == 30
    np.testing.assert_allclose(got, want, **TRAJECTORY_TOL)
    assert got[-1] < got[0]
    assert want_acc > 0.8 and got_acc > 0.8
    assert [sorted(layer) for layer in restored] == [["b", "w"]] * 2
    assert restored[0]["w"].shape == (16, 32)


def test_worker_error_surfaces(tmp_path):
    def scenario(rt, train, trainer, storage):
        def loop(config):
            raise RuntimeError("train loop exploded")

        result = trainer(loop,
                         scaling_config=train.ScalingConfig(num_workers=2),
                         run_config=train.RunConfig(storage_path=storage)).fit()
        return type(result.error).__name__, "exploded" in str(result.error)

    assert _both(scenario, tmp_path) == ("RuntimeError", True)


def test_failure_recovery_from_checkpoint(tmp_path):
    def scenario(rt, train, trainer, storage):
        crash_once = threading.Event()

        def loop(config):
            ckpt = train.get_checkpoint()
            start = ckpt.to_dict()["step"] + 1 if ckpt is not None else 0
            for i in range(start, 5):
                train.report({"step": i},
                             checkpoint=train.Checkpoint.from_dict({"step": i}))
                if i == 2 and not crash_once.is_set():
                    crash_once.set()
                    raise RuntimeError("simulated worker crash")

        result = trainer(
            loop, scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(
                storage_path=storage,
                failure_config=train.FailureConfig(max_failures=1))).fit()
        return (result.error, result.metrics["step"],
                [m["step"] for m in result.metrics_history])

    assert _both(scenario, tmp_path) == (None, 4, [0, 1, 2, 3, 4])


def _register_scores(train, path, scores, **kwargs):
    manager = train.CheckpointManager(path, **kwargs)
    for score in scores:
        manager.register(train.Checkpoint.from_dict({"score": score}),
                         {"score": score})
    return manager


def test_checkpoint_top_k(tmp_path):
    def scenario(rt, train, trainer, storage):
        manager = _register_scores(train, storage, (1.0, 5.0, 3.0, 4.0),
                                   num_to_keep=2, metric="score")
        return manager.best_checkpoint().to_dict()["score"]

    assert _both(scenario, tmp_path) == 5.0


def test_checkpoint_rapid_register_no_collision(tmp_path):
    def scenario(rt, train, trainer, storage):
        manager = _register_scores(train, storage, (1.0, 5.0, 3.0, 4.0),
                                   num_to_keep=2, metric="score")
        return (manager.latest_checkpoint().to_dict()["score"],
                manager.best_checkpoint().to_dict()["score"])

    assert _both(scenario, tmp_path) == (4.0, 5.0)


def test_checkpoint_latest_is_insertion_order(tmp_path):
    def scenario(rt, train, trainer, storage):
        manager = train.CheckpointManager(storage)
        for i in range(12):
            manager.register(train.Checkpoint.from_dict({"step": i}),
                             {"step": i})
        return manager.latest_checkpoint().to_dict()["step"]

    assert _both(scenario, tmp_path) == 11


def test_scaling_config_resources():
    want = jax_train.ScalingConfig(num_workers=2, use_tpu=True,
                                   chips_per_worker=4).worker_resources()
    got = port_train.ScalingConfig(num_workers=2, use_gpu=True,
                                   gpus_per_worker=4).worker_resources()
    assert want == {"TPU": 4.0, "CPU": 1.0}
    assert got == {"GPU": 4.0, "CPU": 1.0}


def _prepare_model(train):
    if train is jax_train:
        from ray_tpu.train.torch import prepare_model
    else:
        from ray_tpu_torch.train.torch import prepare_model
    return prepare_model


def test_torch_trainer_ddp_semantics(tmp_path):
    """prepare_model broadcasts rank-0 params and averages gradients
    across ranks (the reference's loop seeds torch's global generator
    per rank; threads share it, so only the loss bound is recorded)."""

    def scenario(rt, train, trainer, storage):
        prepare_model = _prepare_model(train)

        def loop(config):
            torch.manual_seed(100 + train.get_context().get_world_rank())
            model = prepare_model(torch.nn.Linear(4, 1))
            w0 = model.weight.detach().numpy().copy()
            opt = torch.optim.SGD(model.parameters(), lr=0.05)
            torch.manual_seed(train.get_context().get_world_rank())
            x = torch.randn(64, 4)
            y = (x.sum(dim=1, keepdim=True) > 0).float()
            last = None
            for _ in range(10):
                opt.zero_grad()
                loss = torch.nn.functional.mse_loss(model(x), y)
                loss.backward()
                opt.step()
                last = float(loss)
            train.report({"loss": last, "w_init_sum": float(w0.sum())})

        result = train.TorchTrainer(
            loop, scaling_config=train.ScalingConfig(
                num_workers=2, resources_per_worker={"CPU": 1}),
            run_config=train.RunConfig(name="torch_ddp_test",
                                       storage_path=storage)).fit()
        return result.error, result.metrics["loss"] < 0.5

    assert _both(scenario, tmp_path) == (None, True)


def test_torch_trainer_ranks_stay_synchronized(tmp_path):
    """Different data per rank, averaged gradients: the replicas hold
    the same weights, and both packages the same ones."""

    def scenario(rt, train, trainer, storage):
        prepare_model = _prepare_model(train)
        if train is jax_train:
            from ray_tpu.train.torch import _group_name
            from ray_tpu.util import collective
        else:
            from ray_tpu_torch.train.torch import _group_name
            from ray_tpu_torch.util import collective

        def loop(config):
            rank = train.get_context().get_world_rank()
            # The same init on both packages, from a private generator:
            # the thread workers share torch's global one.
            model = torch.nn.Linear(3, 2)
            init = torch.Generator().manual_seed(0)
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(torch.randn(p.shape, generator=init))
            model = prepare_model(model)
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            gen = torch.Generator().manual_seed(1000 + rank)
            for _ in range(5):
                x = torch.randn(16, 3, generator=gen)
                opt.zero_grad()
                model(x).pow(2).mean().backward()
                opt.step()
            wsum = float(model.weight.detach().double().sum())
            all_sums = collective.allgather(np.array([wsum]),
                                            group_name=_group_name())
            spread = max(float(s[0]) for s in all_sums) - min(
                float(s[0]) for s in all_sums)
            train.report({"spread": spread, "wsum": wsum})

        result = train.TorchTrainer(
            loop, scaling_config=train.ScalingConfig(
                num_workers=2, resources_per_worker={"CPU": 1}),
            run_config=train.RunConfig(name="torch_sync_test",
                                       storage_path=storage)).fit()
        return result.error, result.metrics

    error, metrics = _both(scenario, tmp_path)
    assert error is None and metrics["spread"] == 0.0


@pytest.mark.parametrize("update", ["clip", "grad_scaler", "manual"])
def test_torch_trainer_edits_act_on_the_averaged_gradient(tmp_path, update):
    """.grad holds the average when backward() returns, so what the loop
    does before its update (clipping, GradScaler's unscale, a
    hand-written SGD step without torch.optim) acts on the average: the
    gradients are equal across ranks right after backward, the replicas
    stay equal, and both packages end with the same weights."""

    def scenario(rt, train, trainer, storage):
        prepare_model = _prepare_model(train)
        if train is jax_train:
            from ray_tpu.train.torch import _group_name
            from ray_tpu.util import collective
        else:
            from ray_tpu_torch.train.torch import _group_name
            from ray_tpu_torch.util import collective

        def flat(tensors):
            return torch.cat([t.detach().flatten() for t in tensors]).numpy()

        def loop(config):
            rank = train.get_context().get_world_rank()
            model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                        torch.nn.Tanh(), torch.nn.Linear(8, 1))
            init = torch.Generator().manual_seed(0)
            with torch.no_grad():
                for p in model.parameters():
                    p.copy_(torch.randn(p.shape, generator=init))
            model = prepare_model(model)
            opt = torch.optim.SGD(model.parameters(), lr=0.1)
            scaler = (torch.amp.GradScaler("cpu", init_scale=2.0 ** 16)
                      if update == "grad_scaler" else None)
            gen = torch.Generator().manual_seed(1000 + rank)
            grads_equal = []
            for _ in range(4):
                x = torch.randn(16, 4, generator=gen)
                y = x.sum(dim=1, keepdim=True).tanh()
                for p in model.parameters():
                    p.grad = None
                loss = (model(x) - y).pow(2).mean()
                (scaler.scale(loss) if scaler else loss).backward()
                grads = collective.allgather(
                    flat(p.grad for p in model.parameters()),
                    group_name=_group_name())
                grads_equal.append(all(np.array_equal(g, grads[0])
                                       for g in grads))
                if update == "manual":
                    with torch.no_grad():
                        for p in model.parameters():
                            p.sub_(0.1 * p.grad)
                    continue
                if scaler:
                    scaler.unscale_(opt)
                torch.nn.utils.clip_grad_norm_(model.parameters(), 0.1)
                if scaler:
                    scaler.step(opt)
                    scaler.update()
                else:
                    opt.step()
            weights = collective.allgather(flat(model.parameters()),
                                           group_name=_group_name())
            train.report({"grads_equal": grads_equal,
                          "replicas_equal": all(np.array_equal(w, weights[0])
                                                for w in weights),
                          "weights": weights[0].tolist()})

        result = train.TorchTrainer(
            loop, scaling_config=train.ScalingConfig(
                num_workers=2, resources_per_worker={"CPU": 1}),
            run_config=train.RunConfig(storage_path=storage)).fit()
        return result.error, result.metrics

    error, metrics = _both(scenario, tmp_path)
    assert error is None
    assert metrics["grads_equal"] == [True] * 4
    assert metrics["replicas_equal"]


# -------------------------------------------------------------- port only


@pytest.fixture
def port_runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def test_prepare_model_bf16_replicas_stay_bitwise_equal(port_runtime,
                                                        tmp_path):
    """bf16 parameters: gradients averaged as bf16 tensors (no numpy),
    the replicas bitwise equal after every step, the loss falling."""
    from ray_tpu_torch.train.torch import _group_name, prepare_model
    from ray_tpu_torch.util import collective

    def loop(config):
        rank = port_train.get_context().get_world_rank()
        gen = torch.Generator().manual_seed(rank)
        model = torch.nn.Sequential(
            torch.nn.Linear(8, 16), torch.nn.Tanh(), torch.nn.Linear(16, 1))
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.randn(p.shape, generator=gen))
        model = prepare_model(model.to(torch.bfloat16))
        opt = torch.optim.SGD(model.parameters(), lr=0.05)
        x = torch.randn(32, 8, generator=gen).to(torch.bfloat16)
        y = x.float().sum(dim=1, keepdim=True).tanh().to(torch.bfloat16)
        equal, losses = [], []
        for _ in range(5):
            opt.zero_grad()
            loss = (model(x) - y).float().pow(2).mean()
            loss.backward()
            opt.step()
            losses.append(loss.item())
            flat = torch.cat([p.detach().flatten() for p in
                              model.parameters()])
            gathered = collective.allgather(flat, group_name=_group_name())
            equal.append(all(torch.equal(g, gathered[0]) for g in gathered)
                         and gathered[0].dtype == torch.bfloat16)
        port_train.report({"equal": equal, "losses": losses})

    result = port_train.TorchTrainer(
        loop, scaling_config=port_train.ScalingConfig(num_workers=2),
        run_config=port_train.RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert result.metrics["equal"] == [True] * 5
    losses = result.metrics["losses"]
    assert losses[-1] < losses[0]


def test_prepare_model_averages_on_the_loop_thread(port_runtime, tmp_path):
    """The loop runs with multithreaded backward off (so on ``cuda`` the
    hooks run on the worker's thread, not the card's shared autograd
    thread), the caller's setting is left as it was, and a backward run
    from another thread is refused before it contributes: the next
    backward on the loop's thread still averages."""
    from ray_tpu_torch.train.torch import _group_name, prepare_model
    from ray_tpu_torch.util import collective

    def loop(config):
        rank = port_train.get_context().get_world_rank()
        model = prepare_model(torch.nn.Linear(2, 1))
        errors = []

        def off_thread():
            try:
                model(torch.ones(1, 2)).sum().backward()
            except RuntimeError as e:
                errors.append(str(e))

        thread = threading.Thread(target=off_thread)
        thread.start()
        thread.join(30)
        model.zero_grad()
        model(torch.full((1, 2), float(rank + 1))).sum().backward()
        grads = collective.allgather(model.weight.grad,
                                     group_name=_group_name())
        port_train.report({
            "multithreaded": torch.autograd.is_multithreading_enabled(),
            "refused": [("off the training loop's thread" in e)
                        for e in errors],
            "grads": [g.tolist() for g in grads]})

    result = port_train.TorchTrainer(
        loop, scaling_config=port_train.ScalingConfig(num_workers=2),
        run_config=port_train.RunConfig(storage_path=str(tmp_path))).fit()
    assert result.error is None, result.error
    assert result.metrics == {"multithreaded": False, "refused": [True],
                              "grads": [[[1.5, 1.5]]] * 2}
    assert torch.autograd.is_multithreading_enabled()


def _train_state(mesh=None):
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.train_step import (
        build_train_step,
        create_train_state,
        default_optimizer,
        place_batch,
        shard_batch,
    )

    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    optimizer = default_optimizer(learning_rate=1e-2, warmup_steps=1,
                                  total_steps=50)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = create_train_state(params, optimizer, mesh,
                               llama.param_logical_axes(cfg), device="cpu")
    tokens = np.random.default_rng(1).integers(0, 256, (2, 17))
    host = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    batch = shard_batch(host, mesh) if mesh is not None \
        else place_batch(host, "cpu")
    step = build_train_step(
        lambda p, b: llama.loss_fn(p, b["tokens"], b["targets"], cfg),
        optimizer)
    for _ in range(2):
        state, _ = step(state, batch)
    return state, lambda: create_train_state(
        params, optimizer, mesh, llama.param_logical_axes(cfg), device="cpu")


def _leaves(state):
    from ray_tpu_torch._private.tree import tree_leaves

    return tree_leaves(state.params) + tree_leaves(state.opt_state["mu"]) \
        + tree_leaves(state.opt_state["nu"])


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def test_dcp_round_trip_of_a_train_state(tmp_path):
    """A TrainState after 2 steps: restored into a fresh state (and
    without a template) bit for bit, step and count included."""
    state, fresh = _train_state()
    ckpt = port_train.Checkpoint.from_state(state, str(tmp_path / "c"))
    restored = ckpt.to_state(fresh())
    assert type(restored) is type(state)
    assert (restored.step, restored.opt_state["count"]) == (2, 2)
    for got, want in zip(_leaves(restored), _leaves(state)):
        assert got.dtype == want.dtype and torch.equal(got, want.detach())
    from ray_tpu_torch._private.tree import tree_leaves

    assert all(p.requires_grad for p in tree_leaves(restored.params))
    plain = ckpt.to_state()
    assert plain["step"] == 2 and plain["opt_state"]["count"] == 2
    assert torch.equal(plain["params"]["embed"]["tokens"], state.params["embed"]["tokens"])


def test_dcp_round_trip_of_a_dtensor_train_state(tmp_path,
                                                 no_process_group):
    """The mesh path's state (DTensors on a gloo world of one): restored
    into a fresh state's placements bit for bit; without a template, as
    plain CPU tensors."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(dp=1), device="cpu")
    state, fresh = _train_state(mesh)
    ckpt = port_train.Checkpoint.from_state(state, str(tmp_path / "c"))
    template = fresh()
    restored = ckpt.to_state(template)
    for got, want, like in zip(_leaves(restored), _leaves(state),
                               _leaves(template)):
        assert isinstance(got, DTensor)
        assert got.placements == like.placements
        assert got.device_mesh == like.device_mesh
        assert torch.equal(_local(got), _local(want).detach())
    plain = ckpt.to_state()
    assert not isinstance(plain["params"]["embed"]["tokens"], DTensor)
    assert torch.equal(plain["params"]["embed"]["tokens"],
                       _local(state.params["embed"]["tokens"]).detach())


def test_failed_dcp_save_raises(tmp_path, monkeypatch):
    """No fallback: a save that fails in DCP raises, and leaves no
    meta.json behind."""
    import torch.distributed.checkpoint as dcp

    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(dcp.FileSystemWriter, "write_data", fail)
    # DCP raises its CheckpointException (a BaseException), naming the
    # rank's error.
    with pytest.raises(dcp.api.CheckpointException, match="disk full"):
        port_train.Checkpoint.from_state({"w": torch.ones(4)},
                                         str(tmp_path / "c"))
    assert not (tmp_path / "c" / "meta.json").exists()
    with pytest.raises(TypeError, match="cannot checkpoint"):
        port_train.Checkpoint.from_state({"w": object()},
                                         str(tmp_path / "d"))


def test_process_workers_and_multi_worker_auto_are_refused():
    with pytest.raises(ValueError, match="item 6"):
        port_train.ScalingConfig(num_workers=2, use_process_workers=True)
    with pytest.raises(ValueError, match="num_workers>1"):
        port_train.MeshTrainer(
            lambda config: None, dist_config="auto",
            scaling_config=port_train.ScalingConfig(num_workers=2))


def test_auto_dist_config_forms_a_world_and_survives_a_restart(
        port_runtime, tmp_path, no_process_group):
    """``"auto"`` at one worker: gloo over a tcp rendezvous, rank 0 of
    1; the restart after a failure finds the group and tolerates it."""
    crashed = threading.Event()

    def loop(config):
        port_train.report({"world": dist.get_world_size(),
                           "rank": dist.get_rank(),
                           "backend": dist.get_backend()})
        if not crashed.is_set():
            crashed.set()
            raise RuntimeError("once")

    result = port_train.MeshTrainer(
        loop, dist_config="auto",
        run_config=port_train.RunConfig(
            storage_path=str(tmp_path),
            failure_config=port_train.FailureConfig(max_failures=1))).fit()
    assert result.error is None, result.error
    assert result.metrics_history == [
        {"world": 1, "rank": 0, "backend": "gloo"}] * 2


# -------------------------------------------- the slice as a whole


LLAMA_STEPS = 6
CKPT_STEPS = (1, 3, 5)
CRASH_AFTER = 3


def _llama_inputs() -> dict:
    from ray_tpu.models import llama as jax_llama

    jax_cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  attention="flash", dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jax_llama.init_params(
        jax_cfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(1).integers(0, 256, (8, 17))
    return {"params": params, "tokens": tokens}


def _port_llama_loop(inputs, crash: threading.Event | None):
    def loop(config):
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.parallel.train_step import (
            build_train_step,
            create_train_state,
            default_optimizer,
            shard_batch,
        )

        cfg = dataclasses.replace(llama.LlamaConfig.tiny(),
                                  attention="flash", dtype=torch.float32)
        mesh = port_train.get_mesh(device="cpu")
        optimizer = default_optimizer(learning_rate=1e-2, warmup_steps=1,
                                      total_steps=50)
        state = create_train_state(
            params_from_numpy(inputs["params"], "cpu"), optimizer, mesh,
            llama.param_logical_axes(cfg))
        ckpt = port_train.get_checkpoint()
        if ckpt is not None:
            state = ckpt.to_state(state)
        tokens = inputs["tokens"]
        batch = shard_batch({"tokens": tokens[:, :-1],
                             "targets": tokens[:, 1:]}, mesh)
        step = build_train_step(
            lambda p, b: llama.loss_fn(p, b["tokens"], b["targets"], cfg),
            optimizer)
        for i in range(state.step, LLAMA_STEPS):
            state, metrics = step(state, batch)
            port_train.report(
                {"step": i, "loss": metrics["loss"].item(),
                 "grad_norm": metrics["grad_norm"].item()},
                checkpoint=port_train.Checkpoint.from_state(state)
                if i in CKPT_STEPS else None)
            if i == CRASH_AFTER and crash is not None \
                    and not crash.is_set():
                crash.set()
                raise RuntimeError("injected failure")

    return loop


def _jax_llama_loop(inputs):
    def loop(config):
        from ray_tpu.models import llama as jax_llama
        from ray_tpu.parallel.train_step import (
            build_train_step,
            create_train_state,
            default_optimizer,
            shard_batch,
        )

        cfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(),
                                  attention="flash", dtype=jnp.float32)
        mesh = jax_train.get_mesh()
        optimizer = default_optimizer(learning_rate=1e-2, warmup_steps=1,
                                      total_steps=50)
        state = create_train_state(
            jax.tree.map(jnp.asarray, inputs["params"]), optimizer, mesh,
            jax_llama.param_logical_axes(cfg))
        tokens = inputs["tokens"]
        batch = shard_batch({"tokens": tokens[:, :-1],
                             "targets": tokens[:, 1:]}, mesh)
        step = build_train_step(
            lambda p, b: jax_llama.loss_fn(p, b["tokens"], b["targets"], cfg),
            optimizer)
        for i in range(LLAMA_STEPS):
            state, metrics = step(state, batch)
            jax_train.report({"step": i, "loss": float(metrics["loss"]),
                              "grad_norm": float(metrics["grad_norm"])})

    return loop


def _trajectory(result) -> list:
    assert result.error is None, result.error
    return [(m["step"], m["loss"], m["grad_norm"])
            for m in result.metrics_history]


def test_mesh_trainer_trains_llama_with_a_failure_and_a_resume(
        tmp_path, no_process_group):
    inputs = _llama_inputs()
    runs = {}
    rt = ray_tpu_torch
    rt.shutdown()
    rt.init(num_cpus=8)
    try:
        for name, crash in (("straight", None),
                            ("resumed", threading.Event())):
            runs[name] = port_train.MeshTrainer(
                _port_llama_loop(inputs, crash),
                scaling_config=port_train.ScalingConfig(num_workers=1),
                run_config=port_train.RunConfig(
                    storage_path=str(tmp_path / name),
                    checkpoint_config=port_train.CheckpointConfig(
                        num_to_keep=2),
                    failure_config=port_train.FailureConfig(
                        max_failures=1))).fit()
        resources = rt.available_resources()
    finally:
        rt.shutdown()
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=8)
    try:
        want = _trajectory(jax_train.JaxTrainer(
            _jax_llama_loop(inputs),
            scaling_config=jax_train.ScalingConfig(num_workers=1),
            run_config=jax_train.RunConfig(
                storage_path=str(tmp_path / "jax"))).fit())
    finally:
        ray_tpu.shutdown()
    straight = _trajectory(runs["straight"])
    resumed = _trajectory(runs["resumed"])
    assert [s for s, _, _ in straight] == list(range(LLAMA_STEPS))
    # Steps 0-3, the failure, then 4-5 from step 3's checkpoint.
    assert [s for s, _, _ in resumed] == [0, 1, 2, 3, 4, 5]
    assert resumed == straight
    np.testing.assert_allclose(np.array(straight)[:, 1:],
                               np.array(want)[:, 1:], **TRAJECTORY_TOL)
    # The checkpoints kept: the last two of steps 1, 3 and 5.
    assert runs["resumed"].checkpoint.to_state()["step"] == LLAMA_STEPS
    assert resources == {"CPU": 8.0}
