"""The port's ``ray://`` drivers, cross-language calls, small ``util``
modules and ``testing`` mocks against the JAX package's, on the CPU.

One module-scoped cluster per package, each listening on a TCP port,
runs ``test_client.py``'s remote-driver scenarios (the drivers are
subprocesses; the port's must not load torch, and leaves no arena
behind), ``test_util_queue_pool.py``'s, ``test_util_multiprocessing.py``'s,
``test_util_joblib.py``'s and ``test_util_misc.py``'s scenarios, the
driver's face of the SLO plane (``test_slo_enforcement.py``), and
``test_mocks_and_checks.py``'s harness cases; each test compares the two
packages' results. The port's copy of the C++ client, built with ``g++``,
passes ``demo.cc``'s and ``worker_demo.cc``'s checks against the port's
cluster, as ``tests/test_cpp_client.py`` runs them against the JAX
package's.

Remote functions, actors and the functions registered for C++ callers
are defined inside the scenarios, so cloudpickle ships them by value and
no worker imports this module (which imports JAX).
"""

import ast
import asyncio
import hashlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu_torch

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("ray_tpu", "ray_tpu_torch")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _short_root():
    """A short directory for sessions: UNIX socket paths in it must stay
    under the kernel's 108-byte limit."""
    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix="rtc", dir=base if len(base) < 48
                            else "/tmp")


def _arena(ns: str, prefix: str) -> str:
    return f"/dev/shm/{prefix}_{hashlib.sha1(ns.encode()).hexdigest()[:16]}"


@pytest.fixture(scope="module")
def clusters():
    from ray_tpu_torch._private.node import session_leftovers

    roots = {"RAY_TPU_TMPDIR": _short_root(),
             "RAY_TPU_TORCH_TMPDIR": _short_root()}
    saved = {k: os.environ.get(k) for k in roots}
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        os.environ.update(roots)
        ray_tpu_torch.init(num_cpus=4, probe_gpu=False, port=_free_port())
        ray_tpu.init(num_cpus=4, probe_tpu=False, port=_free_port())
        yield {"ray_tpu": ray_tpu, "ray_tpu_torch": ray_tpu_torch,
               "root": roots["RAY_TPU_TORCH_TMPDIR"]}
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            port_root = roots["RAY_TPU_TORCH_TMPDIR"]
            for p in session_leftovers(port_root)[1]:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            for root in roots.values():
                shutil.rmtree(root, ignore_errors=True)


def _both(clusters, scenario):
    """``scenario(rt)`` on both packages, one after the other: (jax, port)."""
    return scenario(clusters["ray_tpu"]), scenario(clusters["ray_tpu_torch"])


def _driver_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", RAY_TPU_JAX_PLATFORM="cpu",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    for k in ("RAY_TPU_ADDRESS", "RAY_TPU_TORCH_ADDRESS",
              "RAY_TPU_TMPDIR", "RAY_TPU_TORCH_TMPDIR"):
        env.pop(k, None)
    return env


def _in_threads(fn, args):
    """``fn(a)`` for each of ``args`` at once; the results in order."""
    out = [None] * len(args)

    def run(i, a):
        try:
            out[i] = fn(a)
        except BaseException as e:  # noqa: BLE001 - raised below
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, a))
               for i, a in enumerate(args)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    for r in out:
        if isinstance(r, BaseException):
            raise r
    return out


# ----------------------------------------------------- ray:// drivers

CLIENT_SCRIPT = textwrap.dedent("""
    import json
    import sys

    import numpy as np

    import {pkg} as rt
    from {pkg}._private.worker import global_worker

    ctx = rt.client({addr!r}).connect()
    w = global_worker()
    out = {{"client_mode": w.client_mode,
            "store_ns": w.session_name + "-c" + w.worker_id.hex()[:8]}}

    # --- tasks round-trip (small/inline results)
    @rt.remote
    def add(a, b):
        return a + b

    out["add"] = rt.get(add.remote(2, 3))

    # --- large put from the client: workers must pull it via the relay
    big = np.arange(500_000, dtype=np.float64)  # ~4MB, way over inline

    @rt.remote
    def total(arr):
        return float(arr.sum())

    out["total"] = rt.get(total.remote(rt.put(big)))

    # --- large task result: the client must pull it back via the relay
    @rt.remote
    def make_big(n):
        return np.ones(n, dtype=np.float64)

    b = rt.get(make_big.remote(400_000))
    out["make_big"] = [list(b.shape), float(b.sum()), str(b.dtype)]

    # --- actors from the client
    @rt.remote
    class Counter:
        def __init__(self):
            self.x = 0

        def incr(self, arr):
            self.x += int(arr[0])
            return self.x

    c = Counter.remote()
    out["incr"] = [rt.get(c.incr.remote(np.full(200_000, 2.0))),
                   rt.get(c.incr.remote(np.full(200_000, 3.0)))]

    # --- __main__-defined ARG classes ride the definition-export cache
    class Payload:
        def __init__(self, tag):
            self.tag = tag

    @rt.remote
    def read_tag(p):
        return p.tag

    out["tags"] = [rt.get(read_tag.remote(Payload("a"))),
                   rt.get(read_tag.remote(Payload("b")))]
    ctx.disconnect()
    out["torch"] = "torch" in sys.modules
    print("RESULT " + json.dumps(out))
""")


def _client_driver(args):
    pkg, addr = args
    script = CLIENT_SCRIPT.format(pkg=pkg, addr=addr)
    proc = subprocess.run([sys.executable, "-c", script], env=_driver_env(),
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, (pkg, proc.stdout, proc.stderr[-4000:])
    return json.loads(proc.stdout.split("RESULT ", 1)[1])


def test_ray_client_driver_gives_the_reference_results(clusters):
    addrs = [clusters[p].client_server_address() for p in PACKAGES]
    assert all(a.startswith("ray://127.0.0.1:") for a in addrs), addrs
    jax_out, port_out = _in_threads(_client_driver,
                                    list(zip(PACKAGES, addrs)))
    # the JAX package's ray:// driver leaves its private arena behind; the
    # port's removes its own at disconnect (CHANGES.md, C11)
    leaked = _arena(jax_out["store_ns"], "rtpu")
    if os.path.exists(leaked):
        os.unlink(leaked)
    assert not os.path.exists(_arena(port_out["store_ns"], "rtpt"))
    # a driver that moves only numpy never loads torch
    assert port_out.pop("torch") is False
    jax_out.pop("torch")
    for out in (jax_out, port_out):
        out.pop("store_ns")
    assert port_out == jax_out
    assert port_out == {
        "client_mode": True, "add": 5,
        "total": float(sum(range(500_000))),
        "make_big": [[400_000], 400_000.0, "float64"],
        "incr": [2, 5], "tags": ["a", "b"]}


def test_same_host_driver_over_tcp(clusters):
    """A second (non-client) driver process over plain TCP."""

    def run(pkg):
        addr = clusters[pkg].client_server_address()[len("ray://"):]
        script = (f"import sys\nimport {pkg} as rt\n"
                  f"rt.init(address={addr!r})\n"
                  "@rt.remote\n"
                  "def sq(x):\n"
                  "    return x * x\n"
                  "from " + pkg + "._private.worker import global_worker\n"
                  "print('ANS', rt.get(sq.remote(7)),\n"
                  "      global_worker().client_mode)\n"
                  "rt.shutdown()\n"
                  "print('TORCH', 'torch' in sys.modules)\n")
        proc = subprocess.run([sys.executable, "-c", script],
                              env=_driver_env(), capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, (pkg, proc.stdout, proc.stderr)
        return proc.stdout

    jax_out, port_out = _in_threads(run, list(PACKAGES))
    assert "ANS 49 False" in jax_out and "ANS 49 False" in port_out
    assert "TORCH False" in port_out


def test_client_names_of_the_reference_api():
    for name in ("ClientBuilder", "ClientContext", "client",
                 "client_server_address", "cpp_function", "java_function",
                 "java_actor_class", "Language", "SCRIPT_MODE",
                 "WORKER_MODE", "LOCAL_MODE", "autoscaler"):
        assert name in ray_tpu_torch.__all__, name
        assert hasattr(ray_tpu_torch, name), name
    for rt in (ray_tpu, ray_tpu_torch):
        assert [m.name for m in rt.Language] == ["PYTHON", "JAVA", "CPP"]
        assert (rt.SCRIPT_MODE, rt.WORKER_MODE, rt.LOCAL_MODE) == (0, 1, 2)
        for fn, args in ((rt.java_function, ("C", "f")),
                         (rt.java_actor_class, ("C",))):
            with pytest.raises(NotImplementedError, match="java workers"):
                fn(*args)
    builder = ray_tpu_torch.client("127.0.0.1:1").namespace("ns")
    assert builder._namespace == "ns"


# ------------------------------------------------------- the C++ client

CPP_DIR = REPO / "ray_tpu_torch" / "native" / "cpp_client"


def _build(tmp_path_factory, source: str) -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ in this environment")
    out = str(tmp_path_factory.mktemp("cpp") / source[:-3])
    subprocess.run([gxx, "-std=c++17", "-O2", "-o", out,
                    str(CPP_DIR / source), "-I", str(CPP_DIR)],
                   check=True, capture_output=True, text=True)
    return out


def test_cpp_client_demo_passes_on_the_port(clusters, tmp_path_factory):
    from ray_tpu_torch import cross_language
    from ray_tpu_torch._private.worker import global_worker

    demo = _build(tmp_path_factory, "demo.cc")
    cross_language.register_function("cpp_add", lambda a, b: a + b)
    cross_language.register_function(
        "cpp_describe", lambda s: {"upper": s.upper(), "len": len(s)})

    def boom():
        raise ValueError("intentional")

    cross_language.register_function("cpp_fails", boom)

    class Counter:
        def __init__(self, start):
            self.x = start

        def add(self, n):
            self.x += n
            return self.x

        def explode(self):
            raise RuntimeError("actor boom")

    cross_language.register_function("cpp_counter_cls", Counter)
    try:
        proc = subprocess.run([demo, global_worker().gcs_address],
                              capture_output=True, text=True, timeout=120)
    finally:
        for name in ("cpp_add", "cpp_describe", "cpp_fails",
                     "cpp_counter_cls"):
            cross_language.unregister_function(name)
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    for line in ("kv OK", "call add OK: 42", "call describe OK",
                 "error propagation OK", "actor API OK", "CPP-CLIENT-OK"):
        assert line in proc.stdout, (line, proc.stdout)


def test_cpp_worker_objects_and_execution_on_the_port(clusters,
                                                       tmp_path_factory):
    """C++ object put/get and a C++ task-execution loop that the port's
    Python driver calls (both directions round-trip)."""
    from ray_tpu_torch import cross_language
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.worker import ObjectRef, global_worker

    binary = _build(tmp_path_factory, "worker_demo.cc")
    w = global_worker()
    sock = os.path.join(tempfile.mkdtemp(prefix="rtcw", dir="/tmp"),
                        "w.sock")
    proc = subprocess.Popen([binary, w.gcs_address, sock],
                            stdout=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        addr = None
        while time.time() < deadline and addr is None:
            addr = w.kv_get("demo_cpp_worker", ns="cppw")
            time.sleep(0.1)
        assert addr is not None, "C++ worker never registered"
        oid_bytes = None
        while time.time() < deadline and oid_bytes is None:
            oid_bytes = w.kv_get("cpp_put_oid")
            time.sleep(0.05)
        assert oid_bytes is not None
        val = ray_tpu_torch.get(ObjectRef(ObjectID(bytes(oid_bytes)), w),
                                timeout=30)
        assert val == {"answer": 42, "who": "cpp"}

        ref = cross_language.put_xlang({"nums": [1, 2, 3], "ok": True})
        assert ray_tpu_torch.get(ref, timeout=30) == {"nums": [1, 2, 3],
                                                      "ok": True}

        mul = ray_tpu_torch.cpp_function("demo_cpp_worker", "mul")
        assert mul(6, 7) == 42
        concat = cross_language.cpp_function("demo_cpp_worker", "concat")
        assert concat("tpu", "native") == "tpu:native"
        boom = cross_language.cpp_function("demo_cpp_worker", "boom")
        with pytest.raises(RuntimeError, match="intentional C\\+\\+"):
            boom()
        assert mul(3, 5) == 15  # the 4th call lets the worker exit

        out, _ = proc.communicate(timeout=60)
        assert "CPP-OBJECTS-OK" in out
        assert "CPP-WORKER-OK" in out
        assert proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        shutil.rmtree(os.path.dirname(sock), ignore_errors=True)


def test_a_python_task_answers_an_xlang_call_with_msgpack(clusters):
    """The worker's xlang dispatch (``worker_main._execute_sync``): a
    function registered for other languages runs with msgpack arguments,
    and its value, or its error as ``__xlang_error__``, comes back as
    msgpack bytes, as the C++ client reads them."""
    import msgpack

    from ray_tpu_torch import cross_language

    assert msgpack.unpackb(cross_language.execute_xlang_task(
        lambda a, b: [a, b, a + b], msgpack.packb([2, 3]))) == [2, 3, 5]
    assert msgpack.unpackb(cross_language.execute_xlang_task(
        lambda: {"k": "v"}, b"")) == {"k": "v"}
    with pytest.raises(ValueError, match="invalid cross-language"):
        cross_language.register_function("a/b", len)


# -------------------------------------------------- util: queue and pool


def _queue_fifo_and_batch(rt):
    from importlib import import_module

    qm = import_module(f"{rt.__name__}.util.queue")
    q = qm.Queue(maxsize=5)
    for i in range(5):
        q.put(i)
    out = [q.full(), q.qsize()]
    try:
        q.put(99, block=False)
    except qm.Full:
        out.append("Full")
    out += [q.get(), q.get_nowait_batch(10), q.empty()]
    for kw in ({"block": False}, {"timeout": 0.2}):
        try:
            q.get(**kw)
        except qm.Empty:
            out.append("Empty")
    q.shutdown()
    return out


def _queue_cross_process(rt):
    from importlib import import_module

    q = import_module(f"{rt.__name__}.util.queue").Queue()

    @rt.remote
    def producer(q, n):
        for i in range(n):
            q.put(i * 11)
        return True

    @rt.remote
    def consumer(q, n):
        return [q.get(timeout=30) for _ in range(n)]

    p = producer.remote(q, 4)
    out = rt.get(consumer.remote(q, 4), timeout=60)
    done = rt.get(p)
    q.shutdown()
    return [done, out]


def _actor_pool_ordered_and_unordered(rt):
    pool_cls = rt.util.ActorPool

    @rt.remote
    class Sq:
        def compute(self, x):
            import time

            time.sleep(0.01 * (x % 3))  # jitter completion order
            return x * x

    pool = pool_cls([Sq.remote() for _ in range(3)])
    out = [list(pool.map(lambda a, v: a.compute.remote(v), range(8))),
           sorted(pool.map_unordered(lambda a, v: a.compute.remote(v),
                                     range(8)))]
    for v in (10, 11, 12, 13):
        pool.submit(lambda a, v: a.compute.remote(v), v)
    out.append([pool.get_next() for _ in range(4)])
    out.append(pool.has_next())
    try:
        pool.get_next()
    except StopIteration:
        out.append("StopIteration")
    return out


def _actor_pool_mix_guard(rt):
    from importlib import import_module

    pool_cls = import_module(f"{rt.__name__}.util.actor_pool").ActorPool

    @rt.remote
    class Id:
        def f(self, x):
            return x

    pool = pool_cls([Id.remote()])
    pool.submit(lambda a, v: a.f.remote(v), 1)
    pool.submit(lambda a, v: a.f.remote(v), 2)
    out = [pool.get_next()]
    try:
        pool.get_next_unordered()
    except ValueError as e:
        out.append("cannot mix" in str(e))
    out.append(pool.get_next())
    pool.submit(lambda a, v: a.f.remote(v), 3)
    out.append(pool.get_next_unordered())
    return out


# ------------------------------------------- util: multiprocessing, joblib


def _pool_cls(rt):
    from importlib import import_module

    return import_module(f"{rt.__name__}.util.multiprocessing").Pool


def _pool_map_and_starmap(rt):
    def sq(x):
        return x * x

    def add(a, b):
        return a + b

    with _pool_cls(rt)(processes=4) as p:
        return [p.map(sq, range(20)),
                p.starmap(add, [(i, i) for i in range(10)])]


def _pool_apply_and_async(rt):
    def sq(x):
        return x * x

    def add(a, b):
        return a + b

    with _pool_cls(rt)() as p:
        out = [p.apply(add, (2, 3))]
        r = p.apply_async(sq, (7,))
        out += [r.get(timeout=60), r.ready(), r.successful()]
        hits = []
        m = p.map_async(sq, range(5), callback=hits.append)
        out += [m.get(timeout=60), hits]
    return out


def _pool_imap_orders(rt):
    def sq(x):
        return x * x

    with _pool_cls(rt)(processes=2) as p:
        return [list(p.imap(sq, range(12), chunksize=3)),
                sorted(p.imap_unordered(sq, range(12), chunksize=3))]


def _pool_async_error_path(rt):
    def boom(x):
        raise ValueError("nope")

    errs = []
    with _pool_cls(rt)() as p:
        r = p.apply_async(boom, (1,), error_callback=errs.append)
        try:
            r.get(timeout=60)
        except ValueError as e:
            out = [str(e)]
        out += [r.ready(), r.successful(),
                [type(e).__name__ for e in errs]]
    return out


def _pool_closed_rejects(rt):
    def sq(x):
        return x * x

    p = _pool_cls(rt)()
    p.close()
    try:
        p.map(sq, [1])
    except ValueError as e:
        out = ["not running" in str(e)]
    p.join()
    return out


def _joblib_over_cluster(rt):
    pytest.importorskip("joblib")
    from importlib import import_module

    from joblib import Parallel, delayed, parallel_backend

    import_module(f"{rt.__name__}.util.joblib").register_ray()

    def cube(x):
        return x ** 3

    with parallel_backend("ray"):
        a = Parallel(n_jobs=4)(delayed(cube)(i) for i in range(20))
    with parallel_backend("ray", n_jobs=-1):
        b = Parallel()(delayed(cube)(i) for i in range(5))
    return [a, b]


UTIL_CASES = {
    "queue_fifo_and_batch": (_queue_fifo_and_batch, [
        True, 5, "Full", 0, [1, 2, 3, 4], True, "Empty", "Empty"]),
    "queue_cross_process": (_queue_cross_process, [True, [0, 11, 22, 33]]),
    "actor_pool_ordered_and_unordered": (
        _actor_pool_ordered_and_unordered, [
            [i * i for i in range(8)], sorted(i * i for i in range(8)),
            [100, 121, 144, 169], False, "StopIteration"]),
    "actor_pool_mix_guard": (_actor_pool_mix_guard, [1, True, 2, 3]),
    "pool_map_and_starmap": (_pool_map_and_starmap, [
        [i * i for i in range(20)], [2 * i for i in range(10)]]),
    "pool_apply_and_async": (_pool_apply_and_async, [
        5, 49, True, True, [0, 1, 4, 9, 16], [[0, 1, 4, 9, 16]]]),
    "pool_imap_orders": (_pool_imap_orders, [
        [i * i for i in range(12)], sorted(i * i for i in range(12))]),
    "pool_async_error_path": (_pool_async_error_path, [
        "nope", True, False, ["ValueError"]]),
    "pool_closed_rejects": (_pool_closed_rejects, [True]),
    "joblib_over_cluster": (_joblib_over_cluster, [
        [i ** 3 for i in range(20)], [0, 1, 8, 27, 64]]),
}


@pytest.mark.parametrize("case", sorted(UTIL_CASES))
def test_util_scenarios_match_the_reference(clusters, case):
    scenario, want = UTIL_CASES[case]
    jax_out, port_out = _both(clusters, scenario)
    assert port_out == jax_out
    assert port_out == want


# ----------------------------------------- util: serializability, labels


def _inspect(pkg, obj, **kw):
    from importlib import import_module

    fn = import_module(f"{pkg}.util").inspect_serializability
    buf = io.StringIO()
    ok, failures = fn(obj, print_file=buf, **kw)
    return (ok, sorted(f.name for f in failures),
            sorted(type(f.obj).__name__ for f in failures),
            "FAILED" in buf.getvalue())


def test_inspect_serializability_matches_the_reference():
    lock = threading.Lock()  # unpicklable

    def task():
        with lock:
            return 1

    class Holder:
        def __init__(self):
            self.fine = 42
            self.ev = threading.Event()  # the culprit member

    cases = [(lambda x: x + 1, {}), (task, {}), (Holder(), {"depth": 4})]
    for obj, kw in cases:
        assert _inspect("ray_tpu_torch", obj, **kw) == \
            _inspect("ray_tpu", obj, **kw)
    ok, names, _, said = _inspect("ray_tpu_torch", task)
    assert not ok and "lock" in names and said
    ok, names, types, _ = _inspect("ray_tpu_torch", Holder(), depth=4)
    # the innermost culprit: the lock inside the Event's condition
    assert not ok and any("lock" in n or "lock" in t
                          for n, t in zip(names, types))
    assert _inspect("ray_tpu_torch", lambda x: x + 1)[:2] == (True, [])


def test_accelerator_constants_are_the_reference_labels():
    from ray_tpu.util import accelerators as ref
    from ray_tpu_torch.util import accelerators as acc

    names = [n for n in vars(ref) if n.isupper()]
    assert len(names) > 20
    assert {n: getattr(acc, n) for n in names} == \
        {n: getattr(ref, n) for n in names}
    assert acc.NVIDIA_H100 == "H100"
    # the TPU pod helpers read a TPU VM and stay in the reference
    for helper in ("get_current_pod_name", "get_current_pod_worker_count",
                   "get_num_tpu_chips_on_node"):
        assert hasattr(ref, helper) and not hasattr(acc, helper)
    assert ray_tpu_torch.util.accelerators is acc


# ------------------------------------------------------------------ slo


def _slo_driver_side(rt):
    from importlib import import_module

    slo = import_module(f"{rt.__name__}.util.slo")
    spec = slo.register("serve-a", event="serve.req.done", field="dur",
                        stat="p99", threshold_s="0.05", breach_windows=3)
    st = slo.status()
    tenant = st["tenants"]["serve-a"]
    action = slo.force("reweight", "noisy", "serve-a")
    out = {"spec": spec, "tenant_keys": sorted(tenant),
           "breached": tenant["breached"],
           "status_keys": sorted(st),
           "action": {k: action[k] for k in ("rung", "offender", "victim",
                                             "forced")},
           "restored": slo.restore("noisy"),
           "restored_again": slo.restore("noisy"),
           "removed": slo.unregister("serve-a")}
    out["gone"] = "serve-a" not in slo.status()["tenants"]
    try:
        slo.force("nuke", "noisy")
    except RuntimeError as e:
        out["bad_rung"] = "failed" in str(e)
    return out


def test_slo_driver_side_matches_the_reference(clusters):
    jax_out, port_out = _both(clusters, _slo_driver_side)
    assert port_out == jax_out
    assert port_out["spec"]["threshold_s"] == 0.05
    assert port_out["spec"]["breach_windows"] == 3
    assert port_out["action"] == {"rung": "reweight", "offender": "noisy",
                                  "victim": "serve-a", "forced": 1}
    assert port_out["restored"] is True and port_out["removed"] is True
    assert port_out["gone"] and port_out["bad_rung"]


# ---------------------------------------------------------------- mocks


def _publisher_unit(pkg):
    from importlib import import_module

    MockConnection = import_module(f"{pkg}.testing").MockConnection
    Publisher = import_module(f"{pkg}._private.pubsub").Publisher
    pub = Publisher()
    c1, c2 = MockConnection("a"), MockConnection("b")
    pub.subscribe("ch", c1, corr=7)
    pub.subscribe("ch", c2, corr=9)
    out = [pub.publish("ch", {"x": 1}), c1.chunks_for(7)[0]["pub"],
           c2.chunks_for(9)[0]["seq"]]
    c2.set_backlog(1 << 30)  # a slow reader: backpressure drops
    out += [pub.publish("ch", {"x": 2}), len(c2.chunks_for(9))]
    c2.set_backlog(0)
    pub.publish("ch", {"x": 3})
    out.append(c2.chunks_for(9)[-1]["dropped"])
    c1.mark_closed()
    out += [pub.publish("ch", {"x": 4}), pub.stats()["ch"]["subscribers"]]
    pub.unsubscribe("ch", c2, 9)
    end = c2.replies_to(9)[-1]
    out += [end["closed"], end["delivered"] >= 2, pub.stats()]
    return out


def _harness_kv_pubsub_and_nodes(pkg):
    from importlib import import_module

    gcs_harness = import_module(f"{pkg}.testing").gcs_harness
    NodeID = import_module(f"{pkg}._private.ids").NodeID

    async def run():
        out = []
        # a session of its own: the reference's tests use "mock"
        async with gcs_harness(session_name=f"mock-{os.getpid()}",
                               store_capacity=64 << 20) as h:
            driver = h.add_client(role="driver")
            await h.dispatch(driver, {"t": "kv_put", "ns": "t", "k": "k1",
                                      "v": b"v1", "i": 1})
            out.append(driver.conn.replies_to(1)[0]["ok"])
            await h.dispatch(driver, {"t": "kv_get", "ns": "t", "k": "k1",
                                      "i": 2})
            out.append(driver.conn.replies_to(2)[0]["v"])
            await h.dispatch(driver, {"t": "sub", "ch": "c", "i": 3})
            other = h.add_client(role="worker")
            await h.dispatch(other, {"t": "pub", "ch": "c",
                                     "m": {"n": 5}, "i": 4})
            out += [driver.conn.chunks_for(3)[0]["pub"],
                    other.conn.replies_to(4)[0]["delivered"]]
            h.disconnect(driver)
            await h.dispatch(other, {"t": "pub", "ch": "c", "m": 1, "i": 5})
            out.append(other.conn.replies_to(5)[0]["delivered"])

            watcher = h.add_client(role="driver")
            await h.dispatch(watcher, {"t": "sub", "ch": "node_events",
                                       "i": 1})
            agent = h.add_client(role="agent")
            await h.dispatch(agent, {
                "t": "hello", "role": "agent",
                "node_id": NodeID.from_random().binary(),
                "resources": {"CPU": 4.0, "GPU": 1.0},
                "hostname": "mockhost", "i": 2})
            h.disconnect(agent)
            events = [c["pub"] for c in watcher.conn.chunks_for(1)]
            out.append(sorted({e["event"] for e in events}))
            out.append([e.get("hostname") for e in events
                        if e["event"] == "node_joined"])
        return out

    out = asyncio.run(run())
    # the reference's harness leaves its arena behind (C11): removed here
    arena = _arena(f"mock-{os.getpid()}", "rtpu")
    if pkg == "ray_tpu" and os.path.exists(arena):
        os.unlink(arena)
    return out + [os.path.exists(_arena(f"mock-{os.getpid()}", "rtpt"))]


@pytest.mark.parametrize("scenario", [_publisher_unit,
                                      _harness_kv_pubsub_and_nodes],
                         ids=["publisher_unit", "harness"])
def test_mocks_match_the_reference(scenario):
    jax_out, port_out = scenario("ray_tpu"), scenario("ray_tpu_torch")
    assert port_out == jax_out
    if scenario is _publisher_unit:
        assert port_out[:3] == [2, {"x": 1}, 1]
        assert port_out[3:] == [1, 1, 1, 1, 1, True, True, {}]
    else:
        assert port_out[:5] == [True, b"v1", {"n": 5}, 1, 0]
        assert {"node_joined", "node_died"} <= set(port_out[5])
        assert port_out[6:] == [["mockhost"], False]


def test_the_mock_harness_builds_the_ports_own_gcs():
    from ray_tpu_torch._private.gcs import GcsServer
    from ray_tpu_torch.testing import gcs_harness

    session = f"mock-{os.getpid()}-own"

    async def run():
        async with gcs_harness(session_name=session,
                               store_capacity=64 << 20) as h:
            return (type(h.server), h.server.session_dir,
                    os.path.exists(_arena(session, "rtpt")))

    cls, session_dir, mapped = asyncio.run(run())
    assert cls is GcsServer
    assert os.path.basename(session_dir).startswith("rtpt_mockgcs_")
    # its arena existed while it ran, and neither it nor its directory
    # outlives it
    assert mapped
    assert not os.path.exists(session_dir)
    assert not os.path.exists(_arena(session, "rtpt"))


# --------------------------------------------------------------- copies

# Copied from the reference with only their names changed (the package,
# the RAY_TPU_ prefix, the rtpu arena prefix); util/accelerators.py keeps
# the constants only, util/__init__.py's lazy names import by name (C12)
# and the mock harness removes its arena (C11), as CHANGES.md lists.
VERBATIM = ("util/actor_pool.py", "util/queue.py", "util/multiprocessing.py",
            "util/joblib.py", "util/check_serialize.py", "util/slo.py",
            "testing/__init__.py", "cross_language.py")
CPP = ("ray_tpu_client.hpp", "demo.cc", "worker_demo.cc")


def _renamed(text: str) -> str:
    text = re.sub(r"\bray_tpu\b(?!_torch)", "ray_tpu_torch", text)
    text = re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", text)
    return re.sub(r"\brtpu", "rtpt", text)


def _code(text: str) -> str:
    """The module's syntax tree without docstrings."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


@pytest.mark.parametrize("module", VERBATIM)
def test_copy_is_the_reference_code_but_for_names(module):
    got = (REPO / "ray_tpu_torch" / module).read_text()
    want = _renamed((REPO / "ray_tpu" / module).read_text())
    assert _code(got) == _code(want)


@pytest.mark.parametrize("source", CPP)
def test_cpp_client_copy_is_the_reference_but_for_names(source):
    got = (CPP_DIR / source).read_text()
    want = _renamed((REPO / "native" / "cpp_client" / source).read_text())
    assert got == want
    if source.endswith(".hpp"):
        assert "namespace ray_tpu_torch {" in got


def _top_defs(path: Path, names, renamed: bool = False):
    text = path.read_text()
    tree = ast.parse(_renamed(text) if renamed else text)
    found = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                node.name in names:
            found[node.name] = node
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) in names:
            found[node.targets[0].id] = node
    assert sorted(found) == sorted(names), (path, sorted(found))
    return [_code(ast.unparse(found[n])) for n in names]


@pytest.mark.parametrize("module,names", [
    ("__init__.py", ["client_server_address", "Language", "SCRIPT_MODE",
                     "WORKER_MODE", "LOCAL_MODE", "cpp_function",
                     "java_function", "java_actor_class", "ClientContext",
                     "ClientBuilder", "client"]),
    ("testing/mocks.py", ["MockConnection", "MockGcsHarness",
                          "gcs_harness"]),
])
def test_the_copied_definitions_are_the_reference_code(module, names):
    assert _top_defs(REPO / "ray_tpu_torch" / module, names) == \
        _top_defs(REPO / "ray_tpu" / module, names, renamed=True)


def test_util_loads_its_actor_modules_lazily():
    """``util.queue``, ``util.actor_pool``, ``util.ActorPool``,
    ``util.accelerators`` and ``util.inspect_serializability`` resolve on
    first use (queue and the pool define actors at import). The
    reference's ``from . import`` in ``__getattr__`` recurses into
    ``__getattr__`` for ``queue`` and ``actor_pool`` until they are
    imported some other way; the port imports them by name (C12)."""
    code = (
        "import sys\n"
        "import ray_tpu_torch.util as u\n"
        "lazy = ('queue', 'actor_pool', 'accelerators', 'check_serialize')\n"
        "assert not [m for m in lazy\n"
        "            if 'ray_tpu_torch.util.' + m in sys.modules]\n"
        "assert u.queue.Queue.__module__ == 'ray_tpu_torch.util.queue'\n"
        "assert u.actor_pool.ActorPool is u.ActorPool\n"
        "assert u.accelerators.NVIDIA_H100 == 'H100'\n"
        "assert callable(u.inspect_serializability)\n"
        "try:\n"
        "    u.nothing\n"
        "except AttributeError as e:\n"
        "    assert 'nothing' in str(e)\n"
        "print('LAZY-OK', 'torch' in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_driver_env(),
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LAZY-OK False" in proc.stdout


def test_init_takes_ray_addresses_as_the_reference():
    """``init``'s ``ray://`` branch is the reference's (client mode over
    the GCS relay), in place of a not-ported gate."""
    def branch(path, renamed):
        text = path.read_text()
        tree = ast.parse(_renamed(text) if renamed else text)
        init = next(n for n in tree.body
                    if isinstance(n, ast.FunctionDef) and n.name == "init")
        ifs = [n for n in ast.walk(init) if isinstance(n, ast.If)
               and "ray://" in ast.unparse(n.test)]
        assert len(ifs) == 1
        return ast.dump(ifs[0])

    assert branch(REPO / "ray_tpu_torch/__init__.py", False) == \
        branch(REPO / "ray_tpu/__init__.py", True)
    assert "not_ported" not in (REPO / "ray_tpu_torch/__init__.py").read_text()
