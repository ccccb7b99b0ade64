"""ray_tpu_torch.train: distributed training orchestration, the port of
``ray_tpu.train``. ``MeshTrainer`` is the counterpart of the reference's
``JaxTrainer``."""

from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    get_checkpoint,
    get_context,
    get_mesh,
    report,
)
from ray_tpu_torch.train.trainer import (
    BaseTrainer,
    DataParallelTrainer,
    MeshTrainer,
    Result,
)
from ray_tpu_torch.train.huggingface import (
    TransformersTrainer,
    causal_lm_loss_fn,
    make_transformers_train_loop,
)
from ray_tpu_torch.train.torch import TorchTrainer

__all__ = [
    "BaseTrainer",
    "TorchTrainer",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointManager",
    "DataParallelTrainer",
    "FailureConfig",
    "MeshTrainer",
    "TransformersTrainer",
    "causal_lm_loss_fn",
    "make_transformers_train_loop",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "get_checkpoint",
    "get_context",
    "get_mesh",
    "report",
]
