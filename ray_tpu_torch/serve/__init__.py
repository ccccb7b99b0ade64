"""ray_tpu_torch.serve: model serving on the port's actor runtime.

The port of ``ray_tpu/serve``: ``@serve.deployment``, ``serve.run``, the
controller and its replicas, the router (power of two choices, multiplex
affinity, load shedding, deadlines), ``@serve.batch``, long-poll
membership, queue-depth and latency autoscaling, and the HTTP proxy. The
paged LLM engine lives in ``serve.llm_engine``; its server is served as
a deployment::

    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.llm_engine import LLMEngineServer

    app = serve.deployment(LLMEngineServer).options(
        num_replicas=1, ray_actor_options={"num_gpus": 1}).bind(config, params)
    handle = serve.run(app)
    handle.remote({"tokens": [1, 2, 3], "max_new_tokens": 8}).result()

The reference's legacy slot server (``serve/llm.py``) is not ported.
"""

from ray_tpu_torch.serve.api import (
    delete,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.config import (
    AutoscalingConfig,
    DeploymentConfig,
    HTTPOptions,
)
from ray_tpu_torch.serve.deployment import Application, Deployment, deployment
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve.router import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
    DeploymentStreamingResponse,
)

__all__ = [
    "Application", "AutoscalingConfig", "Deployment", "DeploymentConfig",
    "DeploymentHandle", "DeploymentResponse", "DeploymentResponseGenerator",
    "DeploymentStreamingResponse", "HTTPOptions", "batch",
    "delete", "deployment", "get_app_handle", "get_deployment_handle",
    "get_multiplexed_model_id", "multiplexed", "run", "shutdown", "start",
    "status",
]
