"""The port's serve control plane against the JAX package's.

Each mirrored case is a scenario of tests/test_serve.py or
tests/test_serve_schema.py that runs once through ``ray_tpu.serve`` and
once through ``ray_tpu_torch.serve``, each under its own runtime
(``init(num_cpus=8)``) and torn down in a ``finally`` (``serve.shutdown``
then ``shutdown``), and returns a plain record; the two records must be
equal, and equal to what the mirrored test asserts. Delays, the latency
report period and the autoscaler's intervals are shortened, and every
wait is bounded. The legacy slot-server cases wait for that part of the
port.

The port-only cases at the end each state how the port differs: it
refuses unknown actor options at deploy, raises a replica constructor's
error from ``serve.run``, keeps a replica's control calls apart from its
requests, lets go of a deployment's arguments at ``shutdown``, and has no
metrics registry behind its handles.
"""

import gc
import itertools
import json
import subprocess
import sys
import textwrap
import threading
import time
import urllib.request
import weakref
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jax_serve
from ray_tpu._private.config import GLOBAL_CONFIG as JAX_CONFIG
from ray_tpu.serve import schema as jax_schema
from ray_tpu_torch import serve as torch_serve
from ray_tpu_torch._private.config import GLOBAL_CONFIG as TORCH_CONFIG
from ray_tpu_torch.serve import schema as torch_schema

PACKAGES = {"ray_tpu": (ray_tpu, jax_serve, JAX_CONFIG, jax_schema),
            "ray_tpu_torch": (ray_tpu_torch, torch_serve, TORCH_CONFIG,
                              torch_schema)}
WAIT_S = 30.0


def _run(scenario, name, config=None, **init):
    rt, serve, global_config, _ = PACKAGES[name]
    rt.shutdown()
    rt.init(**{"num_cpus": 8, **init})
    global_config.update(config or {})
    try:
        return scenario(rt, serve)
    finally:
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
            global_config.reset()


def _both(scenario, **kwargs) -> dict:
    return {name: _run(scenario, name, **kwargs) for name in PACKAGES}


def _until(predicate, wait_s: float = WAIT_S) -> bool:
    deadline = time.monotonic() + wait_s
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.05)
    return True


def _concurrently(fn, n: int) -> list:
    """``fn(i)`` for i < n, each on its own thread, started together."""
    results = [None] * n
    barrier = threading.Barrier(n)

    def run(i):
        barrier.wait(WAIT_S)
        results[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S * 2)
    assert not any(t.is_alive() for t in threads)
    return results


# ----------------------------------------------- mirrored: test_serve.py


def function_deployment(rt, serve):
    @serve.deployment
    def doubler(x):
        return x * 2

    handle = serve.run(doubler.bind(), name="doubler_app")
    return handle.remote(21).result(timeout_s=WAIT_S)


def class_deployment_and_methods(rt, serve):
    @serve.deployment
    class Counter:
        def __init__(self, start):
            self.count = start

        def __call__(self, inc):
            self.count += inc
            return self.count

        def peek(self):
            return self.count

    handle = serve.run(Counter.bind(10), name="counter_app")
    return [handle.remote(5).result(timeout_s=WAIT_S),
            handle.peek.remote().result(timeout_s=WAIT_S),
            handle.options(method_name="peek").remote().result(
                timeout_s=WAIT_S)]


def multiple_replicas_spread_load(rt, serve):
    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __init__(self):
            self.id = id(self)

        def __call__(self, _):
            time.sleep(0.05)
            return self.id

    handle = serve.run(WhoAmI.bind(), name="who_app")
    results = _concurrently(
        lambda i: handle.remote(None).result(timeout_s=WAIT_S), 12)
    return [len(results), len(set(results)) >= 2,
            serve.status()["who_app::WhoAmI"]["running_replicas"]]


def deployment_graph_handles(rt, serve):
    @serve.deployment
    class Preprocess:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Ingress:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result(timeout_s=WAIT_S) * 10

    handle = serve.run(Ingress.bind(Preprocess.bind()), name="graph_app")
    return [handle.remote(4).result(timeout_s=WAIT_S),
            sorted(serve.status())]


def batching(rt, serve):
    seen_batch_sizes = []

    @serve.deployment
    class BatchAdder:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.2)
        def __call__(self, xs):
            seen_batch_sizes.append(len(xs))
            return [x + 100 for x in xs]

    handle = serve.run(BatchAdder.bind(), name="batch_app")
    results = _concurrently(
        lambda i: handle.remote(i).result(timeout_s=WAIT_S), 8)
    return [sorted(results), max(seen_batch_sizes) >= 2]


def user_config_reconfigure(rt, serve):
    @serve.deployment(user_config={"mult": 2})
    class Mult:
        def __init__(self):
            self.mult = 1

        def reconfigure(self, cfg):
            self.mult = cfg["mult"]

        def __call__(self, x):
            return x * self.mult

    handle = serve.run(Mult.bind(), name="cfg_app")
    first = handle.remote(3).result(timeout_s=WAIT_S)
    serve.run(Mult.options(user_config={"mult": 5}).bind(), name="cfg_app")
    changed = _until(lambda: handle.remote(3).result(timeout_s=WAIT_S) == 15)
    return [first, changed]


def autoscaling_up(rt, serve):
    @serve.deployment(autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=4, target_ongoing_requests=1,
        metrics_interval_s=0.1, upscale_delay_s=0.1, downscale_delay_s=60))
    class Slow:
        def __call__(self, _):
            time.sleep(0.5)
            return "ok"

    handle = serve.run(Slow.bind(), name="auto_app")
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            handle.remote(None).result(timeout_s=WAIT_S)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    scaled = _until(lambda: serve.status().get("auto_app::Slow", {}).get(
        "running_replicas", 0) >= 2)
    stop.set()
    for t in threads:
        t.join(WAIT_S)
    return scaled


def http_proxy(rt, serve):
    serve.start(http_options={"host": "127.0.0.1", "port": 0})

    @serve.deployment
    def echo(body):
        return {"got": body}

    serve.run(echo.bind(), name="http_app", route_prefix="/")
    port = sys.modules[serve.__name__ + ".api"]._proxy.port
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/", data=json.dumps({"a": 1}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
        return json.loads(resp.read())


def replica_recovery_after_delete(rt, serve):
    @serve.deployment
    def ping(_):
        return "pong"

    handle = serve.run(ping.bind(), name="kill_app")
    first = handle.remote(None).result(timeout_s=WAIT_S)
    running = serve.status()["kill_app::ping"]["running_replicas"]
    serve.delete("kill_app")
    gone = _until(lambda: "kill_app::ping" not in serve.status())
    handle2 = serve.run(ping.bind(), name="kill_app")
    return [first, running, gone, handle2.remote(None).result(
        timeout_s=WAIT_S)]


def replica_recovery_after_kill(rt, serve):
    """A replica killed out from under the controller is replaced by the
    health check, and requests are served again."""
    @serve.deployment(health_check_period_s=0.1)
    def ping(_):
        return "pong"

    handle = serve.run(ping.bind(), name="kill_app")
    first = handle.remote(None).result(timeout_s=WAIT_S)
    router = sys.modules[serve.__name__ + ".router"]._routers[
        ("kill_app", "ping")]
    victim = router._replicas[0]
    rt.kill(victim)

    def served():
        try:
            return handle.remote(None).result(timeout_s=WAIT_S) == "pong"
        except Exception:  # noqa: BLE001 — the dead replica, until replaced
            return False

    return [first, _until(served), router._replicas[0] != victim]


def multiplexed_model_serving(rt, serve):
    loads = []

    @serve.deployment(num_replicas=2)
    class ModelServer:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id: str):
            loads.append(model_id)
            return lambda x: f"{model_id}:{x}"

        def __call__(self, x):
            return self.get_model()(x)

    handle = serve.run(ModelServer.bind(), name="mux_app")
    outs = [handle.options(multiplexed_model_id="m1").remote("a").result(
        timeout_s=WAIT_S) for _ in range(3)]
    outs.append(handle.options(multiplexed_model_id="m2").remote("b").result(
        timeout_s=WAIT_S))

    @serve.deployment
    def plain(x):
        return serve.get_multiplexed_model_id()

    handle2 = serve.run(plain.bind(), name="plain_app")
    return [outs, loads.count("m1"), handle2.remote("x").result(
        timeout_s=WAIT_S)]


def streaming_response_overlaps_production(rt, serve):
    @serve.deployment
    class Tokens:
        def generate(self, n: int):
            for i in range(n):
                time.sleep(0.15)
                yield f"tok{i}"

    handle = serve.run(Tokens.bind(), name="stream_app")
    t0 = time.monotonic()
    first_chunk_at = None
    chunks = []
    for chunk in handle.options(method_name="generate", stream=True).remote(4):
        if first_chunk_at is None:
            first_chunk_at = time.monotonic() - t0
        chunks.append(chunk)
    total = time.monotonic() - t0
    return [chunks, first_chunk_at < total / 2]


def streaming_error_and_unary_fallback(rt, serve):
    @serve.deployment
    class Flaky:
        def boom(self):
            yield "one"
            raise RuntimeError("mid-stream failure")

        def plain(self, x):
            return x + 1

    handle = serve.run(Flaky.bind(), name="stream_err_app")
    got = []
    try:
        for chunk in handle.options(method_name="boom", stream=True).remote():
            got.append(chunk)
        error = None
    except RuntimeError as exc:
        error = str(exc)
    return [got, error, list(handle.options(method_name="plain",
                                            stream=True).remote(41))]


def streaming_early_abandon_stops_production(rt, serve):
    @serve.deployment
    class Endless:
        def generate(self):
            for i in range(200):
                time.sleep(0.02)
                yield i

    handle = serve.run(Endless.bind(), name="abandon_app")
    stream = handle.options(method_name="generate", stream=True).remote()
    got = []
    for chunk in stream:
        got.append(chunk)
        if len(got) >= 3:
            break
    again = list(itertools.islice(
        handle.options(method_name="generate", stream=True).remote(), 2))
    return [got, stream._queue is None, stream._replica_idx is None, again]


def latency_autoscaling_up_then_down(rt, serve):
    @serve.deployment(autoscaling_config=serve.AutoscalingConfig(
        min_replicas=1, max_replicas=3, target_ongoing_requests=1,
        metrics_interval_s=0.1, upscale_delay_s=0.1,
        downscale_delay_s=0.5, target_p99_s=0.02))
    class SlowLLM:
        def __call__(self, mode):
            time.sleep(0.2 if mode == "slow" else 0.001)
            return "ok"

    handle = serve.run(SlowLLM.bind(), name="lat_auto_app")

    def replicas():
        return serve.status().get("lat_auto_app::SlowLLM", {}).get(
            "running_replicas", 0)

    def load(mode, n, pause):
        stop = threading.Event()

        def loop():
            while not stop.is_set():
                handle.remote(mode).result(timeout_s=WAIT_S)
                time.sleep(pause)

        threads = [threading.Thread(target=loop) for _ in range(n)]
        for t in threads:
            t.start()
        return stop, threads

    stop, threads = load("slow", 6, 0.0)
    scaled_up = _until(lambda: replicas() >= 2)
    stop.set()
    for t in threads:
        t.join(WAIT_S)
    controller = sys.modules[serve.__name__ + ".api"]._get_controller()
    report = rt.get(controller.get_latency_report.remote(
        "lat_auto_app", "SlowLLM"), timeout=WAIT_S)
    # Recovered load: a fast trickle keeps the windowed feed fresh.
    stop, threads = load("fast", 1, 0.3)
    scaled_down = _until(lambda: replicas() <= 1)
    stop.set()
    for t in threads:
        t.join(WAIT_S)
    return [scaled_up, report.get("p99_s", 0) > 0.02, scaled_down]


def process_replicas_overlap_requests(rt, serve):
    """tests/test_serve.py:360: one process replica overlaps 6 slow
    requests (about one request of wall time) in another process."""
    import os as _os

    @serve.deployment(num_replicas=1,
                      ray_actor_options={"process": True,
                                         "max_concurrency": 8})
    class Slow:
        def __call__(self, seconds):
            import os
            import time as _t

            _t.sleep(seconds)
            return os.getpid()

    handle = serve.run(Slow.bind(), name="slow_proc_app")
    handle.remote(0.0).result(timeout_s=WAIT_S)  # the process is up
    start = time.monotonic()
    responses = [handle.remote(0.5) for _ in range(6)]
    pids = {r.result(timeout_s=WAIT_S) for r in responses}
    elapsed = time.monotonic() - start
    return [elapsed < 2.0, bool(pids) and _os.getpid() not in pids]


SERVE_CASES = {
    function_deployment: 42,
    class_deployment_and_methods: [15, 15, 15],
    multiple_replicas_spread_load: [12, True, 3],
    deployment_graph_handles: [50, ["graph_app::Ingress",
                                    "graph_app::Preprocess"]],
    batching: [[100 + i for i in range(8)], True],
    user_config_reconfigure: [6, True],
    autoscaling_up: True,
    http_proxy: {"got": {"a": 1}},
    replica_recovery_after_delete: ["pong", 1, True, "pong"],
    replica_recovery_after_kill: ["pong", True, True],
    multiplexed_model_serving: [["m1:a"] * 3 + ["m2:b"], 1, ""],
    streaming_response_overlaps_production: [
        ["tok0", "tok1", "tok2", "tok3"], True],
    streaming_error_and_unary_fallback: [["one"], "mid-stream failure", [42]],
    streaming_early_abandon_stops_production: [[0, 1, 2], True, True, [0, 1]],
    process_replicas_overlap_requests: [True, True],
}
LATENCY_CONFIG = {"serve_latency_report_s": 0.1}


@pytest.mark.parametrize("scenario", list(SERVE_CASES),
                         ids=lambda f: f.__name__)
def test_serve_parity(scenario):
    records = _both(scenario)
    assert records["ray_tpu_torch"] == records["ray_tpu"]
    assert records["ray_tpu_torch"] == SERVE_CASES[scenario]


def test_latency_autoscaling_parity():
    records = _both(latency_autoscaling_up_then_down, config=LATENCY_CONFIG)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [True, True, True]


# ---------------------------------------- mirrored: test_serve_schema.py

APP_MODULE = """
    from {package} import serve

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Gateway:
        def __init__(self, doubler):
            self.doubler = doubler

        def __call__(self, body):
            doubled = self.doubler.remote(body["x"]).result(timeout_s=30)
            return {{"doubled": doubled}}

    app = Gateway.bind(Doubler.bind())

    @serve.deployment(num_replicas=1)
    def pinger(_):
        return "pong"

    ping_app = pinger.bind()
"""


@pytest.fixture
def app_modules(tmp_path, monkeypatch):
    """Per package, the name of a module of bound applications."""
    names = {}
    for package in PACKAGES:
        name = f"demo_serve_app_{package}"
        (tmp_path / f"{name}.py").write_text(
            textwrap.dedent(APP_MODULE.format(package=package)))
        names[package] = name
    monkeypatch.syspath_prepend(str(tmp_path))
    yield names
    for name in names.values():
        sys.modules.pop(name, None)


def _schema_run(scenario, tmp_path, app_modules) -> dict:
    records = {}
    for name in PACKAGES:
        schema = PACKAGES[name][3]

        def load(text, module=app_modules[name], schema=schema):
            path = tmp_path / f"serve_config_{name}.yaml"
            path.write_text(textwrap.dedent(text).replace("MODULE", module))
            return schema.ServeDeployConfig.from_yaml(str(path))

        records[name] = _run(
            lambda rt, serve: scenario(rt, serve, schema, load), name)
    return records


def test_yaml_deploy_with_overrides(tmp_path, app_modules):
    def scenario(rt, serve, schema, load):
        cfg = load("""
            http_options:
              host: 127.0.0.1
              port: 0
            applications:
              - name: main
                route_prefix: /main
                import_path: MODULE:app
                deployments:
                  - name: Doubler
                    num_replicas: 2
              - name: ping
                import_path: MODULE:ping_app
        """)
        deployed = schema.deploy_config(cfg)
        target = serve.status()["main::Doubler"]["target_replicas"]
        via_handle = serve.get_app_handle("main").remote(
            {"x": 21}).result(timeout_s=WAIT_S)
        port = sys.modules[serve.__name__ + ".api"]._proxy.port
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/main",
            data=json.dumps({"x": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            via_http = json.loads(resp.read())
        return [deployed, target, via_handle, via_http]

    records = _schema_run(scenario, tmp_path, app_modules)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [["main", "ping"], 2, {"doubled": 42}, {"doubled": 8}]


def test_redeploy_removes_absent_apps(tmp_path, app_modules):
    def scenario(rt, serve, schema, load):
        both = load("""
            applications:
              - name: main
                import_path: MODULE:app
              - name: ping
                import_path: MODULE:ping_app
        """)
        first = schema.deploy_config(both)
        apps = sorted({k.split("::", 1)[0] for k in serve.status()})
        only_ping = load("""
            applications:
              - name: ping
                import_path: MODULE:ping_app
        """)
        second = schema.deploy_config(only_ping)
        left = sorted({k.split("::", 1)[0] for k in serve.status()})
        return [first, apps, second, left, serve.get_app_handle(
            "ping").remote(None).result(timeout_s=WAIT_S)]

    records = _schema_run(scenario, tmp_path, app_modules)
    assert records["ray_tpu_torch"] == records["ray_tpu"] == \
        [["main", "ping"], ["main", "ping"], ["ping"], ["ping"], "pong"]


def test_override_unknown_deployment_rejected(tmp_path, app_modules):
    def scenario(rt, serve, schema, load):
        cfg = load("""
            applications:
              - name: main
                import_path: MODULE:app
                deployments:
                  - name: NoSuchDeployment
                    num_replicas: 2
        """)
        try:
            schema.deploy_config(cfg)
        except ValueError as exc:
            return "not in the graph" in str(exc)
        return None

    records = _schema_run(scenario, tmp_path, app_modules)
    assert records["ray_tpu_torch"] == records["ray_tpu"] is True


SCHEMA_ERRORS = [
    ({}, "no applications"),
    ({"applications": [{"name": "x", "import_path": "nope"}]},
     "import_path"),
    ({"applications": [{"import_path": "a:b", "bogus": 1}]},
     "unknown application field"),
    ({"applications": [{"import_path": "a:b", "name": "x"},
                       {"import_path": "a:c", "name": "x"}]},
     "duplicate application"),
    ({"applications": [{"import_path": "a:b",
                        "deployments": [{"num_replicas": 2}]}]},
     "needs a 'name'"),
]


@pytest.mark.parametrize("config,match", SCHEMA_ERRORS,
                         ids=[m for _, m in SCHEMA_ERRORS])
def test_schema_validation_errors(config, match):
    messages = {}
    for name, (_, _, _, schema) in PACKAGES.items():
        with pytest.raises(ValueError, match=match) as err:
            schema.ServeDeployConfig.from_dict(config)
        messages[name] = str(err.value)
    assert messages["ray_tpu_torch"] == messages["ray_tpu"]


# ------------------------------------------------------------- port only


def _torch(scenario, **init):
    return _run(scenario, "ray_tpu_torch", **init)


def test_process_replicas_are_refused_at_deploy():
    """A replica's actor options are checked at deploy: an unknown one
    fails ``serve.run`` with a ValueError, a process replica's as a
    thread replica's, and no replica is started. (A process replica
    with valid options serves: ``process_replicas_overlap_requests``.)"""
    def scenario(rt, serve):
        @serve.deployment(ray_actor_options={"process": True, "bogus": 1})
        def f(x):
            return x

        with pytest.raises(ValueError, match="Invalid options"):
            serve.run(f.bind(), name="proc_app")
        with pytest.raises(ValueError, match="Invalid options"):
            serve.run(f.options(ray_actor_options={"bogus": 1}).bind(),
                      name="bogus_app")
        return serve.status()

    assert _torch(scenario) == {}


def test_a_failed_replica_constructor_is_raised_by_run():
    """The replica's constructor error comes out of ``serve.run`` typed
    (an ActorError with the constructor's exception as its cause), the
    deployment reads DEPLOY_FAILED, and no replica is started again."""
    constructed = []

    def scenario(rt, serve):
        @serve.deployment
        class Broken:
            def __init__(self):
                constructed.append(1)
                raise RuntimeError("no weights")

        with pytest.raises(rt.exceptions.ActorError) as err:
            serve.run(Broken.bind(), name="broken_app")
        time.sleep(0.3)  # reconcile passes that must not retry it
        return [type(err.value.cause).__name__, str(err.value.cause),
                serve.status()["broken_app::Broken"]["status"],
                serve.status()["broken_app::Broken"]["running_replicas"],
                len(constructed)]

    assert _torch(scenario) == ["RuntimeError", "no weights",
                                "DEPLOY_FAILED", 0, 1]


def test_control_calls_are_not_starved_by_requests():
    """A replica whose request threads are all busy still answers the
    controller's probes: they run in its ``control`` concurrency group."""
    def scenario(rt, serve):
        release = threading.Event()
        started = threading.Semaphore(0)

        @serve.deployment(max_ongoing_requests=2,
                          ray_actor_options={"max_concurrency": 2})
        class Busy:
            def __call__(self, _):
                started.release()
                release.wait(WAIT_S)
                return "done"

        handle = serve.run(Busy.bind(), name="busy_app")
        responses = [handle.remote(i) for i in range(2)]
        for _ in range(2):
            started.acquire(timeout=WAIT_S)
        replica = sys.modules[serve.__name__ + ".router"]._routers[
            ("busy_app", "Busy")]._replicas[0]
        metrics = rt.get(replica.get_metrics.remote(), timeout=2.0)
        healthy = rt.get(replica.check_health.remote(), timeout=2.0)
        release.set()
        return [metrics["num_ongoing_requests"], healthy,
                [r.result(timeout_s=WAIT_S) for r in responses]]

    assert _torch(scenario) == [2, True, ["done", "done"]]


def test_shutdown_lets_go_of_the_arguments_and_gives_the_gpu_back():
    """After ``serve.shutdown()`` the replicas (``num_gpus=0.5`` each) are
    gone with their ``GPU``, and nothing holds the bound arguments: the
    controller's state, the routers and the module's controller and
    applications are cleared."""
    class Weights:
        pass

    def scenario(rt, serve):
        weights = Weights()
        alive = weakref.ref(weights)

        @serve.deployment(num_replicas=2,
                          ray_actor_options={"num_gpus": 0.5})
        class Model:
            def __init__(self, w):
                self.w = w

            def __call__(self, _):
                return self.w is not None

        handle = serve.run(Model.bind(weights), name="gpu_app")
        served = _concurrently(
            lambda i: handle.remote(i).result(timeout_s=WAIT_S), 4)
        held = rt.available_resources()["GPU"]
        del weights
        serve.shutdown()
        api = sys.modules[serve.__name__ + ".api"]
        router = sys.modules[serve.__name__ + ".router"]
        return [served, held, rt.available_resources()["GPU"],
                alive() is None, api._controller, api._apps,
                router._routers]

    assert _torch(scenario, num_gpus=1) == \
        [[True] * 4, 0.0, 1.0, True, None, {}, {}]


SERVE_WITHOUT_REGISTRY = textwrap.dedent("""
    import json, sys, time

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch._private.config import GLOBAL_CONFIG

    rt.init(num_cpus=8)
    GLOBAL_CONFIG.update({"serve_latency_report_s": 0.1})

    @serve.deployment
    def f(x):
        return x + 1

    serve.run(f.bind(), name="plain_app")
    handle = serve.get_deployment_handle("f", "plain_app")
    outs = [handle.remote(i).result(timeout_s=30.0) for i in range(3)]
    controller = sys.modules["ray_tpu_torch.serve.api"]._get_controller()
    deadline = time.monotonic() + 30.0
    reported = False
    while not reported and time.monotonic() < deadline:
        reported = rt.get(controller.get_latency_report.remote(
            "plain_app", "f")).get("count", 0) >= 1
        time.sleep(0.05)
    stats = sys.modules["ray_tpu_torch.serve.router"]._routers[
        ("plain_app", "f")].latency_stats()
    metrics = sorted(m for m in sys.modules if m.startswith("ray_tpu_torch")
                     and "metrics" in m and "history" not in m)
    serve.shutdown()
    rt.shutdown()
    print(json.dumps([outs, reported, stats["count"] >= 3, metrics]))
""")


def test_handles_need_no_metrics_registry():
    """The port's router keeps its latency histogram and report without
    the metrics registry (``util.metrics``; serve's Prometheus collector
    is not ported): ``get_deployment_handle`` serves, the windowed
    report reaches the controller, and after serving no metrics module
    of the port (the registry, the agent) was imported, lazily or not.
    The scenario runs in a fresh interpreter, so modules that other
    files in this process imported do not count."""
    done = subprocess.run(
        [sys.executable, "-c", SERVE_WITHOUT_REGISTRY],
        capture_output=True, text=True, timeout=120,
        cwd=str(Path(__file__).resolve().parents[1]))
    assert done.returncode == 0, done.stderr[-3000:]
    assert json.loads(done.stdout.strip().splitlines()[-1]) == \
        [[1, 2, 3], True, True, []]


def test_dead_streams_leave_no_queue_actor_thread():
    """Each streaming request's queue actor ends with its stream, and so
    does the actor's submit thread."""
    def scenario(rt, serve):
        @serve.deployment
        class Tokens:
            def generate(self, n):
                yield from range(n)

        handle = serve.run(Tokens.bind(), name="threads_app")
        list(handle.options(method_name="generate", stream=True).remote(3))
        gc.collect()
        before = threading.active_count()
        outs = [list(handle.options(method_name="generate",
                                    stream=True).remote(3))
                for _ in range(10)]
        gc.collect()
        return [outs, _until(lambda: threading.active_count() <= before,
                             5.0)]

    assert _torch(scenario) == [[[0, 1, 2]] * 10, True]
