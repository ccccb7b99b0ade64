"""The port's HuggingFace integration against the JAX package's.

The mirror of tests/test_train.py's ``TransformersTrainer`` case runs
through both packages (the reference's Flax GPT-2 under optax, the
port's PyTorch ``GPT2LMHeadModel`` under ``torch.optim``; both built from
a config, nothing downloaded) and records whether the causal LM loss
dropped; the two records must be equal. ``causal_lm_loss_fn`` is held
against the reference's on one tiny GPT-2 whose Flax params go to
PyTorch through ``transformers.modeling_flax_pytorch_utils``: within
1e-5. Both cases skip where ``transformers`` is not installed (the
card's machine has none).

Where the port deliberately differs: ``TransformersTrainer`` is a
``MeshTrainer``, its ``optimizer`` a factory of a ``torch.optim``
optimizer (where the reference takes an optax transformation), and the
loss function takes the batch only (the model holds its parameters).
The reference marks its case slow; this file runs in about 35 s on the
CPU, most of it importing Flax and TensorFlow (the converter's).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import train as jax_train
from ray_tpu_torch import train as port_train

PACKAGES = {"ray_tpu": (ray_tpu, jax_train),
            "ray_tpu_torch": (ray_tpu_torch, port_train)}


def test_causal_lm_loss_matches_the_flax_loss():
    """One tiny GPT-2: the Flax params into the PyTorch model through
    transformers' converter; the loss, with and without an attention
    mask, within 1e-5 of the reference's."""
    transformers = pytest.importorskip("transformers")
    from transformers.modeling_flax_pytorch_utils import (
        load_flax_weights_in_pytorch_model,
    )

    from ray_tpu.train.huggingface import causal_lm_loss_fn as jax_loss_fn
    from ray_tpu_torch.train.huggingface import causal_lm_loss_fn

    cfg = transformers.GPT2Config(vocab_size=128, n_positions=32, n_embd=32,
                                  n_layer=2, n_head=2, resid_pdrop=0.0,
                                  embd_pdrop=0.0, attn_pdrop=0.0)
    flax_model = transformers.FlaxGPT2LMHeadModel(cfg, seed=0)
    model = load_flax_weights_in_pytorch_model(
        transformers.GPT2LMHeadModel(cfg), flax_model.params)
    model.train()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 128, (4, 16)).astype(np.int32)
    mask = (rng.random((4, 16)) > 0.2).astype(np.int32)
    for batch in ({"input_ids": ids}, {"input_ids": ids,
                                       "attention_mask": mask}):
        want = float(jax_loss_fn(flax_model)(
            flax_model.params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0)))
        got = causal_lm_loss_fn(model)(
            {k: torch.tensor(v).long() for k, v in batch.items()}).item()
        assert abs(got - want) <= 1e-5, (got, want)


def test_transformers_trainer_finetunes_tiny_gpt2(tmp_path):
    """A tiny GPT-2 (from config, no network) trains end to end through
    the worker group and its causal LM loss drops (the reference's Flax
    model, the port's PyTorch one)."""
    transformers = pytest.importorskip("transformers")
    import optax

    rng = np.random.default_rng(0)
    starts = rng.integers(0, 96, size=(64, 1))
    data = (starts + np.arange(16)[None, :]) % 128
    batches = [{"input_ids": data[i:i + 8].astype(np.int32)}
               for i in range(0, 64, 8)]
    cfg = dict(vocab_size=128, n_positions=32, n_embd=32, n_layer=2,
               n_head=2)

    def scenario(train, storage):
        if train is jax_train:
            kwargs = dict(optimizer=optax.adamw(1e-3))
            model = lambda: transformers.FlaxGPT2LMHeadModel(
                transformers.GPT2Config(**cfg), seed=0)
        else:
            kwargs = dict(optimizer=functools.partial(
                torch.optim.AdamW, lr=1e-3, weight_decay=1e-4),
                device="cpu")
            model = lambda: transformers.GPT2LMHeadModel(
                transformers.GPT2Config(**cfg))
        result = train.TransformersTrainer(
            model, train_dataset=batches, num_epochs=15, report_every=4,
            scaling_config=train.ScalingConfig(num_workers=1),
            run_config=train.RunConfig(storage_path=storage), **kwargs).fit()
        losses = [m["loss"] for m in result.metrics_history if "loss" in m]
        return (result.error, len(losses) >= 2,
                losses[-1] < losses[0] * 0.7)

    records = {}
    for name, (rt, train) in PACKAGES.items():
        rt.shutdown()
        rt.init(num_cpus=8)
        try:
            records[name] = scenario(train, str(tmp_path / name))
        finally:
            rt.shutdown()
    assert records["ray_tpu_torch"] == records["ray_tpu"], records
    assert records["ray_tpu_torch"] == (None, True, True)
