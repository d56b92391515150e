"""The port's Serve runtime against the JAX package's, on the CPU.

One module-scoped cluster of each package (``ray_tpu`` and
``ray_tpu_torch``) runs the same deployments, taken from the JAX
package's serve tests (``test_serve.py``, ``test_serve_api2.py``,
``test_serve_config.py``, ``test_serve_multiplex.py``,
``test_serve_rpc.py``, ``test_serve_streaming.py`` and
``test_serve_llm.py``); each test compares what the two return. Both
Serve instances are shut down after every test.

The LLM apps run ``LLAMA_DEBUG`` in fp32 on weights from JAX's
``init_params`` (the port's carried across by ``models/convert.py``), so
their tokens must be equal, not close: exact token equality is the
tolerance. The JAX package's weights are rebuilt from the same numpy
arrays in its replica.

Deployments and model factories are defined inside the tests, so
cloudpickle ships them by value and no worker imports this module (which
imports JAX); the config-file apps are small modules written before the
clusters start, so the workers find them on the driver's path.
"""

import asyncio
import glob
import json
import os
import shutil
import sys
import tempfile
import textwrap
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import serve as jserve
from ray_tpu.models import llama as jllama
from ray_tpu.serve import config_file as jconfig
from ray_tpu.serve import llm as jllm
from ray_tpu.serve import rpc_client as jrpc
from ray_tpu_torch import serve as tserve
from ray_tpu_torch.serve import config_file as tconfig
from ray_tpu_torch.serve import llm as tllm
from ray_tpu_torch.serve import rpc_client as trpc

SIDES = {
    "jax": dict(rt=ray_tpu, serve=jserve, config=jconfig, rpc=jrpc,
                build=jllm.build_llm_app, extra={}),
    "port": dict(rt=ray_tpu_torch, serve=tserve, config=tconfig, rpc=trpc,
                 build=tllm.build_llm_app, extra={"device": "cpu"}),
}

APP_MODULE = textwrap.dedent("""\
    from {pkg} import serve


    @serve.deployment
    class Doubler:
        def __init__(self, factor: int = 2):
            self.factor = factor

        def __call__(self, req):
            return {{"out": req.json()["x"] * self.factor}}


    app = Doubler.bind()


    def build(factor: int = 2):
        return Doubler.bind(factor)
""")


def _session_root():
    """A short directory for the port's sessions: UNIX socket paths in it
    must stay under the kernel's 108-byte limit."""
    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix="rtt", dir=base if len(base) < 48
                            else "/tmp")


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    apps = tmp_path_factory.mktemp("serve_apps")
    for side, pkg in (("jax", "ray_tpu"), ("port", "ray_tpu_torch")):
        (apps / f"{side}_serve_app.py").write_text(APP_MODULE.format(pkg=pkg))
    # before the clusters start: their workers take the driver's path
    sys.path.insert(0, str(apps))
    root = _session_root()
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    session = None
    # a cluster another module left behind would lack this one's settings
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        os.environ["RAY_TPU_TORCH_TMPDIR"] = root
        try:
            ray_tpu_torch.init(num_cpus=4, num_gpus=1, probe_gpu=False)
        finally:
            if saved is None:
                os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
            else:
                os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        session = ray_tpu_torch._private.worker.global_worker().session_name
        ray_tpu.init(num_cpus=4, probe_tpu=False, ignore_reinit_error=True)
        yield
    finally:
        try:
            for side in SIDES.values():
                if side["rt"].is_initialized():
                    side["serve"].shutdown()
        finally:
            try:
                ray_tpu_torch.shutdown()
            finally:
                ray_tpu.shutdown()
                for p in glob.glob("/dev/shm/rtpt*"):
                    if session is not None and session[-8:] in p:
                        try:
                            os.unlink(p)
                        except OSError:
                            pass
                shutil.rmtree(root, ignore_errors=True)
                if str(apps) in sys.path:
                    sys.path.remove(str(apps))


@pytest.fixture(autouse=True)
def _fresh_serve(clusters):
    yield
    for side in SIDES.values():
        side["serve"].shutdown()
        # the kills land asynchronously, and a controller still alive
        # under its name would be found by the next test's serve.run
        assert _until(lambda: _alive_actors(side["rt"]) == [])


def _both(scenario, *args):
    """Run ``scenario(name, *args)`` on both packages at once: (jax,
    port)."""
    with ThreadPoolExecutor(2) as pool:
        jax_f, port_f = (pool.submit(scenario, n, *args)
                         for n in ("jax", "port"))
        return jax_f.result(), port_f.result()


def _http(serve, route, body=None, *, sse=False, method=None):
    """(status, body bytes) of one request to the side's HTTP proxy."""
    headers = {"Content-Type": "application/json"}
    if sse:
        headers["Accept"] = "text/event-stream"
    data = None if body is None else (
        body if isinstance(body, bytes) else json.dumps(body).encode())
    req = urllib.request.Request(
        f"http://127.0.0.1:{serve.get_proxy_port()}{route}", data=data,
        headers=headers, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post_json(serve, route, body):
    status, raw = _http(serve, route, body)
    assert status == 200, (status, raw)
    return json.loads(raw)


def _sse(raw: bytes):
    return [json.loads(line[len(b"data: "):])
            for line in raw.split(b"\n\n") if line.startswith(b"data: ")]


def _alive_actors(rt):
    """The names of the side's live actors ("" for a replica): the tests
    here start no actor but Serve's."""
    from importlib import import_module

    state = import_module(f"{rt.__name__}.util.state")
    return sorted(a["name"] for a in state.list_actors(limit=10000)
                  if a["state"] == "alive")


def _until(pred, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.1)
    return pred()


# ------------------------------------------------------------ the API


def _unary(name):
    side = SIDES[name]
    serve = side["serve"]
    serve.start()

    @serve.deployment(num_replicas=2, user_config={"mult": 3})
    class Echo:
        def __init__(self, offset=0):
            self.offset = offset
            self.mult = 1

        def reconfigure(self, cfg):
            self.mult = cfg["mult"]

        def __call__(self, req):
            body = req if isinstance(req, dict) else req.json()
            return {"echo": body, "n": body.get("x", 0) * self.mult
                    + self.offset}

        def add(self, a, b):
            return a + b

        def who(self):
            ctx = serve.get_replica_context()
            return [ctx.app_name, ctx.deployment]

    @serve.deployment
    def square(x):
        return x * x

    @serve.deployment
    class Outer:
        def __init__(self, inner):
            self.inner = inner

        async def __call__(self, x):
            return await self.inner.remote(x) + 1

    h = serve.run(Echo.bind(5), name="echo", route_prefix="/echo")
    fn = serve.run(square.bind(), name="square", route_prefix=None)
    outer = serve.run(Outer.bind(square.bind()), name="outer",
                      route_prefix=None)
    local = serve.run(Outer.bind(square.bind()), _local_testing_mode=True)
    return {
        "handle": h.remote({"x": 2}).result(timeout=120),
        "method": h.add.remote(2, 3).result(timeout=120),
        "who": h.who.remote().result(timeout=120),
        "function": fn.remote(7).result(timeout=120),
        "composed": outer.remote(4).result(timeout=120),
        "local": local.remote(4).result(),
        "app_handle": serve.get_app_handle("echo").add.remote(
            1, 1).result(timeout=120),
        "http": json.loads(_http(serve, "/echo", {"x": 4})[1]),
        "http_sub": json.loads(_http(serve, "/echo/sub", {"x": 1})[1]),
        "http_404": _http(serve, "/nothing", {"x": 1})[0],
        "healthz": _http(serve, "/-/healthz")[1],
        "status": serve.status(),
    }


def test_unary_calls_match(clusters):
    jax_out, port_out = _both(_unary)
    assert port_out == jax_out
    assert port_out["handle"] == {"echo": {"x": 2}, "n": 11}
    assert port_out["composed"] == port_out["local"] == 17
    assert port_out["http_404"] == 404
    assert port_out["status"]["echo"] == {"Echo": {"num_replicas": 2}}


def _streams(name):
    side = SIDES[name]
    serve = side["serve"]

    @serve.deployment
    class Gen:
        def __call__(self, req):
            n = req["n"] if isinstance(req, dict) else req.json()["n"]
            for i in range(n):
                yield {"tok": i}

        async def agen(self, n):
            for i in range(n):
                await asyncio.sleep(0)
                yield i * i

    h = serve.run(Gen.bind(), name="gen", route_prefix="/gen")

    async def collect(handle, *args):
        return [c async for c in handle.stream(*args)]

    status, chunked = _http(serve, "/gen", {"n": 3})
    return {
        "handle": asyncio.run(collect(h, {"n": 4})),
        "async_gen": asyncio.run(collect(h.agen, 5)),
        "chunked": (status, chunked),
        "sse": _sse(_http(serve, "/gen", {"n": 3}, sse=True)[1]),
        "one_chunk": _http(serve, "/gen", {"n": 1})[1],
    }


def test_streamed_chunks_match(clusters):
    jax_out, port_out = _both(_streams)
    assert port_out == jax_out
    assert port_out["handle"] == [{"tok": i} for i in range(4)]
    assert port_out["sse"] == [{"tok": i} for i in range(3)]


def _batches(name):
    side = SIDES[name]
    serve = side["serve"]

    @serve.deployment
    class Batched:
        def __init__(self):
            self.sizes = []

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.5)
        async def handle(self, items):
            self.sizes.append(len(items))
            return [i * 10 for i in items]

        async def __call__(self, x):
            return await self.handle(x)

        def batch_sizes(self):
            return self.sizes

    h = serve.run(Batched.bind(), name="batch", route_prefix=None)
    full = sorted(r.result(timeout=120) for r in
                  [h.remote(i) for i in range(8)])
    partial = sorted(r.result(timeout=120) for r in
                     [h.remote(i) for i in range(3)])
    return {"full": full, "partial": partial,
            "sizes": h.batch_sizes.remote().result(timeout=120)}


def test_batch_sizes_match(clusters):
    jax_out, port_out = _both(_batches)
    assert port_out == jax_out
    assert port_out["sizes"] == [4, 4, 3]


def _multiplexed(name):
    side = SIDES[name]
    serve = side["serve"]

    @serve.deployment
    class Multi:
        def __init__(self):
            self.loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        async def get_model(self, model_id: str):
            self.loads.append(model_id)
            return {"id": model_id, "scale": len(model_id)}

        async def __call__(self, x: float):
            model = await self.get_model(serve.get_multiplexed_model_id())
            return [model["id"], x * model["scale"]]

        def loaded(self):
            return self.loads

    h = serve.run(Multi.bind(), name="multi", route_prefix=None)
    calls = [("aa", 2.0), ("bbb", 2.0), ("aa", 3.0), ("cccc", 1.0),
             ("bbb", 1.0), ("aa", 1.0)]
    out = [h.options(multiplexed_model_id=m).remote(x).result(timeout=120)
           for m, x in calls]
    return {"out": out, "loads": h.loaded.remote().result(timeout=120)}


def test_multiplexed_ids_and_lru_eviction_match(clusters):
    jax_out, port_out = _both(_multiplexed)
    assert port_out == jax_out
    # "bbb" was evicted by "cccc" (two models a replica), "aa" by "bbb"
    assert port_out["loads"] == ["aa", "bbb", "cccc", "bbb", "aa"]


def _asgi(name):
    side = SIDES[name]
    serve = side["serve"]

    async def asgi_app(scope, receive, send):
        msg = await receive()
        if scope["path"].endswith("/echo"):
            payload = {"path": scope["path"], "method": scope["method"],
                       "got": msg.get("body", b"").decode()}
            await send({"type": "http.response.start", "status": 201,
                        "headers": [(b"x-served-by", b"serve")]})
            await send({"type": "http.response.body",
                        "body": json.dumps(payload).encode()})
        else:
            await send({"type": "http.response.start", "status": 404,
                        "headers": []})
            await send({"type": "http.response.body", "body": b"nope"})

    @serve.ingress(asgi_app)
    class Api:
        def ping(self):
            return "pong"

    h = serve.run(serve.deployment(Api).bind(), name="asgi",
                  route_prefix="/asgi")
    return {"echo": _http(serve, "/asgi/echo", b"ping"),
            "missing": _http(serve, "/asgi/missing", method="GET"),
            "method": h.ping.remote().result(timeout=120)}


def test_asgi_ingress_matches(clusters):
    jax_out, port_out = _both(_asgi)
    assert port_out == jax_out
    assert port_out["echo"][0] == 201 and port_out["missing"][0] == 404


def _config_file(name, path):
    side = SIDES[name]
    names = side["config"].deploy_config(path)
    serve = side["serve"]
    return {"names": names, "double": _post_json(serve, "/double", {"x": 5}),
            "triple": _post_json(serve, "/triple", {"x": 5}),
            "status": serve.status()}


def test_config_file_deploy_matches(clusters, tmp_path):
    for name in SIDES:
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(textwrap.dedent(f"""\
            applications:
              - name: doubles
                route_prefix: /double
                import_path: {name}_serve_app:app
              - name: triples
                route_prefix: /triple
                import_path: {name}_serve_app.build
                args: {{factor: 3}}
        """))
    jax_out, port_out = _both(
        lambda name: _config_file(name, str(tmp_path / f"{name}.yaml")))
    assert port_out == jax_out
    assert port_out["triple"] == {"out": 15}


def _rpc(name):
    side = SIDES[name]
    serve = side["serve"]

    @serve.deployment
    class Echo:
        def __call__(self, req):
            data = req.json()
            if data.get("boom"):
                raise ValueError("boom")
            return {"echo": data, "raw": b"\x00\x01"}

    @serve.deployment
    class Gen:
        def __call__(self, req):
            for i in range(int(req.json()["n"])):
                yield {"tok": i}

    serve.run(Echo.bind(), name="echo", route_prefix="/echo")
    serve.run(Gen.bind(), name="gen", route_prefix="/gen")
    rpc = side["rpc"]
    with rpc.ServeRpcClient(port=serve.get_rpc_port()) as c:
        out = {"healthz": c.healthz(), "routes": c.routes(),
               "unary": [c.call("/echo", {"x": i}) for i in range(3)],
               "stream": list(c.stream("/gen", {"n": 4})),
               "unary_of_stream": c.call("/gen", {"n": 3})}
        for key, call in (("error", lambda: c.call("/echo", {"boom": 1})),
                          ("no_route", lambda: c.call("/none", {}))):
            try:
                call()
            except rpc.ServeRpcError as e:
                out[key] = type(e).__name__
    return out


def test_rpc_ingress_matches(clusters):
    jax_out, port_out = _both(_rpc)
    assert port_out == jax_out
    assert port_out["stream"] == [{"tok": i} for i in range(4)]
    assert port_out["unary"][0] == {"echo": {"x": 0}, "raw": b"\x00\x01"}
    assert port_out["error"] == port_out["no_route"] == "ServeRpcError"


def _scale_and_retry(name):
    side = SIDES[name]
    rt, serve = side["rt"], side["serve"]
    from importlib import import_module

    controller = import_module(f"{rt.__name__}.serve.controller")

    @serve.deployment(num_replicas=1)
    class Who:
        def __init__(self):
            self.pid = os.getpid()

        def __call__(self, req):
            return self.pid

    serve.run(Who.bind(), name="who", route_prefix=None)
    h = serve.get_deployment_handle("Who", "who")
    one = {h.remote(None).result(timeout=120) for _ in range(4)}
    ctl = controller.get_controller()
    rt.get(ctl.scale.remote("who", "Who", 3))
    scaled = serve.status()
    seen = set()

    def saw_two():
        # the config push reaches the handle: it routes to a new replica
        seen.add(h.remote(None).result(timeout=120))
        return len(seen) >= 2

    _until(saw_two)
    replicas = rt.get(ctl.get_replicas.remote("who", "Who"))
    rt.kill(replicas[0])
    # every request lands: one routed to the killed replica retries
    retried = [h.remote(None).result(timeout=120) for _ in range(10)]
    rt.get(ctl.scale.remote("who", "Who", 1))
    return {"one": len(one), "scaled": scaled, "seen": len(seen) >= 2,
            "retried": all(isinstance(p, int) for p in retried),
            "after": serve.status()}


def test_scale_and_a_killed_replica_match(clusters):
    jax_out, port_out = _both(_scale_and_retry)
    assert port_out == jax_out
    assert port_out["scaled"] == {"who": {"Who": {"num_replicas": 3}}}
    assert port_out["retried"] and port_out["seen"]


def _teardown(name):
    side = SIDES[name]
    rt, serve = side["rt"], side["serve"]

    @serve.deployment(num_replicas=2)
    def noop(x):
        return x

    serve.run(noop.bind(), name="a", route_prefix="/a")
    serve.run(noop.bind(), name="b", route_prefix=None)
    up = _alive_actors(rt)
    serve.delete("a")
    def b_left():
        alive = _alive_actors(rt)
        return alive if alive.count("") == 2 else None

    after_delete = _until(b_left)
    status = serve.status()
    serve.shutdown()
    gone = _until(lambda: _alive_actors(rt) == [])
    return {"up": up, "after_delete": after_delete, "status": status,
            "gone": gone}


def test_delete_and_shutdown_leave_no_replica(clusters):
    jax_out, port_out = _both(_teardown)
    assert port_out == jax_out
    assert port_out["up"] == [""] * 4 + ["SERVE_CONTROLLER", "SERVE_PROXY"]
    assert port_out["after_delete"] == [""] * 2 + ["SERVE_CONTROLLER",
                                                   "SERVE_PROXY"]
    assert port_out["status"] == {"b": {"noop": {"num_replicas": 2}}}
    assert port_out["gone"] is True


# ------------------------------------------------------------ the LLM app


def _to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    cfg = jllama.LLAMA_DEBUG
    return (_to_numpy(jllama.init_params(cfg, jax.random.PRNGKey(0))),
            _to_numpy(jllama.init_params(cfg, jax.random.PRNGKey(1))))


def _factories(name, tree):
    """(model factory, draft factory, the tree to ``put`` for a refresh)
    of one side, defined here so they ship by value."""
    if name == "jax":
        from ray_tpu.models import llama as jl
        from ray_tpu.models import speculative as jspec

        def model():
            return (jax.tree_util.tree_map(jnp.asarray, tree),
                    jl.LLAMA_DEBUG)

        return model, (lambda p, c: jspec.truncated_draft(p, c, 1)), tree
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import speculative as tspec
    from ray_tpu_torch.models.convert import params_from_numpy

    def model():
        import torch

        torch.set_num_threads(1)
        return params_from_numpy(tree, device="cpu"), tl.LLAMA_DEBUG

    return (model, (lambda p, c: tspec.truncated_draft(p, c, 1)),
            params_from_numpy(tree, device="cpu"))


def _greedy(tree, prompt, n):
    return jllama.generate_greedy(
        jax.tree_util.tree_map(jnp.asarray, tree),
        jnp.asarray([prompt], jnp.int32), jllama.LLAMA_DEBUG,
        max_new=n)[0].tolist()


def _llm_dense(name, weights):
    side = SIDES[name]
    rt, serve = side["rt"], side["serve"]
    model, draft, _ = _factories(name, weights[0])
    h = serve.run(side["build"](model, max_slots=3, max_len=96,
                                draft_factory=draft, draft_k=3,
                                **side["extra"]),
                  name="llm", route_prefix="/llm")
    out = {"greedy": _post_json(serve, "/llm", {"prompt": [1, 2, 3],
                                               "max_new_tokens": 10}),
           "concurrent": [f.result(timeout=120) for f in [
               h.remote({"prompt": p, "max_new_tokens": n})
               for p, n in (([4, 5, 6, 7], 8), ([9], 12), ([11, 12], 5))]],
           "stream": _sse(_http(serve, "/llm", {
               "prompt": [20, 21, 22], "max_new_tokens": 6,
               "stream": True}, sse=True)[1]),
           "speculative": _post_json(serve, "/llm", {
               "prompt": [1, 2, 3], "max_new_tokens": 10,
               "speculative": True})["tokens"]}
    _, _, new = _factories(name, weights[1])
    assert h.reconfigure.remote(
        {"weights_ref": rt.put(new)}).result(timeout=120) is None
    out["refreshed"] = _post_json(serve, "/llm", {"prompt": [7, 8, 9],
                                                 "max_new_tokens": 8})
    out["version"] = _post_json(serve, "/llm", {"_admin": "stats"})[
        "weights_version"]
    return out


def test_llm_app_matches_through_http(clusters, weights):
    """Greedy, concurrent, streamed and speculative requests, then a
    ``weights_ref`` refresh: the same tokens from both packages, and the
    JAX greedy decode's before and after the refresh."""
    jax_out, port_out = _both(_llm_dense, weights)
    assert port_out == jax_out
    assert port_out["greedy"]["tokens"] == _greedy(weights[0], [1, 2, 3], 10)
    assert port_out["speculative"] == port_out["greedy"]["tokens"]
    assert port_out["stream"] == _greedy(weights[0], [20, 21, 22], 6)
    assert port_out["refreshed"]["tokens"] == _greedy(weights[1],
                                                      [7, 8, 9], 8)
    assert port_out["version"] == 2


def _llm_paged(name, weights):
    side = SIDES[name]
    rt, serve = side["rt"], side["serve"]
    model, _, _ = _factories(name, weights[0])
    h = serve.run(side["build"](model, max_slots=2, kv_cache="paged",
                                num_pages=24, page_size=8, max_len=96,
                                enable_prefix_cache=True, **side["extra"]),
                  name="paged", route_prefix="/paged")
    prompt = list(range(10, 26))  # two full pages: they enter the cache
    req = {"prompt": prompt, "max_new_tokens": 8}
    out = {"before": _post_json(serve, "/paged", req),
           "hit": _post_json(serve, "/paged", req)}
    _, _, new = _factories(name, weights[1])
    h.reconfigure.remote({"weights_ref": rt.put(new)}).result(timeout=120)
    out["after"] = _post_json(serve, "/paged", req)
    out["version"] = _post_json(serve, "/paged", {"_admin": "stats"})[
        "weights_version"]
    return out


def test_paged_llm_app_refresh_drops_the_prefix_cache(clusters, weights):
    """The paged app's cached prefix pages hold the old weights' K/V: after
    the refresh the same prompt gives the new weights' greedy tokens."""
    jax_out, port_out = _both(_llm_paged, weights)
    assert port_out == jax_out
    prompt = list(range(10, 26))
    assert port_out["before"]["tokens"] == port_out["hit"]["tokens"] == \
        _greedy(weights[0], prompt, 8)
    assert port_out["after"]["tokens"] == _greedy(weights[1], prompt, 8)
    assert port_out["version"] == 2


def test_port_llm_replica_loads_no_jax(clusters, weights):
    """A live replica hosting the port's ``LLMServer`` has torch and the
    port's serve stack loaded, and nothing of ``ray_tpu``, JAX or
    ``ml_dtypes``."""
    model, _, _ = _factories("port", weights[0])

    class Probe(tllm.LLMServer):
        def modules(self):
            return sorted(sys.modules)

    h = tserve.run(tserve.deployment(Probe).bind(
        model, max_slots=1, max_len=32, device="cpu"), name="probe",
        route_prefix=None)
    mods = h.modules.remote().result(timeout=120)
    assert {"torch", "ray_tpu_torch.serve.llm",
            "ray_tpu_torch.serve.deployment"} <= set(mods)
    assert not [m for m in mods if m.split(".")[0] in
                ("ray_tpu", "jax", "jaxlib", "ml_dtypes")]
