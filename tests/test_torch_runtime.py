"""The port's runtime core against the JAX package's, on the CPU.

One module-scoped cluster per package (``ray_tpu`` and ``ray_tpu_torch``)
runs the same scenarios, taken from ``test_core_tasks.py``,
``test_core_actors.py``, ``test_core_objects.py`` and ``test_core_pg.py``;
each test compares the two packages' results, exception class names and
resource keys. The port's GPU pinning (C3's first fix) and its tensor
transport are checked on the port alone, with what the JAX package does
recorded beside them.

Remote functions are defined inside the scenarios, so cloudpickle ships
them by value and no worker imports this module (which imports JAX).
The fixtures shut both clusters down and remove the port's arenas and
session directory, failures included.
"""

import ast
import glob
import os
import re
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch

GPUS = 2


def _session_root():
    """A short directory for the port's sessions: UNIX socket paths in it
    must stay under the kernel's 108-byte limit."""
    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix="rtt", dir=base if len(base) < 48
                            else "/tmp")


def _port_arenas(session: str):
    return [p for p in glob.glob("/dev/shm/rtpt*")
            if session[-8:] in p]


@pytest.fixture(scope="module")
def clusters():
    root = _session_root()
    saved = {k: os.environ.get(k) for k in
             ("RAY_TPU_TORCH_TMPDIR", "PYTHONPROFILEIMPORTTIME")}
    session = None
    # a cluster another module left behind would lack this one's resources
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        os.environ["RAY_TPU_TORCH_TMPDIR"] = root
        # the port's session processes log their imports (stderr goes to
        # the session logs), so the import rule can be read off the head
        os.environ["PYTHONPROFILEIMPORTTIME"] = "1"
        try:
            ray_tpu_torch.init(num_cpus=4, num_gpus=GPUS, probe_gpu=False)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        session = ray_tpu_torch._private.worker.global_worker().session_name
        ray_tpu.init(num_cpus=4, probe_tpu=False, resources={"GPU": GPUS},
                     ignore_reinit_error=True)
        yield {"jax": ray_tpu, "port": ray_tpu_torch, "root": root,
               "session": session}
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for p in _port_arenas(session or "unset"):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            shutil.rmtree(root, ignore_errors=True)


def _both(clusters, scenario):
    """Run ``scenario(rt)`` on both packages; return (jax, port)."""
    return scenario(clusters["jax"]), scenario(clusters["port"])


def _outcome(fn):
    """A value, or the class name of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return ("raised", type(e).__name__)


# ------------------------------------------------------------ tasks


def _tasks(rt):
    @rt.remote
    def add(a, b=10):
        return a + b

    @rt.remote(num_returns=2)
    def two(x):
        return x, x * 2

    @rt.remote
    def outer(n):
        return rt.get([add.remote(i) for i in range(n)])

    @rt.remote
    def total(xs):
        return sum(xs)

    first, second = two.remote(7)
    ref = add.remote(1)
    return {
        "kwargs": rt.get(add.remote(1, b=2)),
        "many": rt.get([add.remote(i) for i in range(20)]),
        "two": rt.get([first, second]),
        "nested": rt.get(outer.remote(3)),
        "ref_arg": rt.get(total.remote(rt.get([ref, add.remote(2)]))),
        "ref_passed": rt.get(add.remote(ref, b=0)),
        "options": rt.get(add.options(num_cpus=2).remote(5)),
    }


def test_tasks_match(clusters):
    jax_out, port_out = _both(clusters, _tasks)
    assert port_out == jax_out
    assert port_out["nested"] == [10, 11, 12]


def _task_errors(rt):
    @rt.remote
    def boom():
        raise ValueError("boom")

    @rt.remote
    def slow():
        time.sleep(30)

    ref, late = boom.remote(), slow.remote()
    out = {"error": _outcome(lambda: rt.get(ref)),
           "timeout": _outcome(lambda: rt.get(late, timeout=0.2))}
    rt.cancel(late, force=True)
    s = slow.remote()
    time.sleep(0.5)
    rt.cancel(s, force=True)
    out["cancel"] = _outcome(lambda: rt.get(s, timeout=20))
    out["put_ref"] = _outcome(lambda: rt.put(rt.put(1)))
    return out


def test_task_errors_and_cancel_match(clusters):
    jax_out, port_out = _both(clusters, _task_errors)
    assert port_out == jax_out
    assert port_out["error"] == ("raised", "ValueError")
    assert port_out["timeout"] == ("raised", "GetTimeoutError")


# ------------------------------------------------------------ objects


def _objects(rt):
    arr = np.random.default_rng(0).random((1024, 256)).astype(np.float32)
    out = rt.get(rt.put(arr))
    values = [1, "s", [1, 2], {"a": (1, 2)}, None, b"bytes", 3.14]

    @rt.remote
    def slow(x):
        time.sleep(x)
        return x

    refs = [slow.remote(0.0), slow.remote(60.0)]
    ready, rest = rt.wait(refs, num_returns=1, timeout=30)
    rt.cancel(refs[1], force=True)
    return {
        "roundtrip": [rt.get(rt.put(v)) for v in values],
        "numpy_equal": bool(np.array_equal(arr, out)),
        "numpy_zero_copy": not out.flags["OWNDATA"],
        "wait": (len(ready), len(rest), rt.get(ready[0])),
        "get_list": rt.get([rt.put(i) for i in range(3)]),
    }


def test_objects_match(clusters):
    jax_out, port_out = _both(clusters, _objects)
    assert port_out == jax_out
    assert port_out["numpy_zero_copy"] and port_out["wait"] == (1, 1, 0.0)


# ------------------------------------------------------------ actors


def _actors(rt):
    @rt.remote
    class Counter:
        def __init__(self, start):
            self.n = start

        def incr(self, by=1):
            self.n += by
            return self.n

        def fail(self):
            raise RuntimeError("actor method failed")

    @rt.remote
    class Broken:
        def __init__(self):
            raise ValueError("no")

        def ping(self):
            return 1

    c = Counter.remote(5)
    order = rt.get([c.incr.remote() for _ in range(10)])
    named = Counter.options(name="port-vs-jax").remote(0)
    rt.get(named.incr.remote(3))
    found = rt.get_actor("port-vs-jax")
    out = {"order": order,
           "named": rt.get(found.incr.remote(1)),
           "method_error": _outcome(lambda: rt.get(c.fail.remote())),
           "init_error": _outcome(
               lambda: rt.get(Broken.remote().ping.remote(),
                                  timeout=20))}
    rt.kill(c)
    time.sleep(0.5)
    out["killed"] = _outcome(lambda: rt.get(c.incr.remote(),
                                                timeout=20))
    rt.kill(named)
    out["missing_name"] = _outcome(lambda: rt.get_actor("no-such"))
    return out


def test_actors_match(clusters):
    jax_out, port_out = _both(clusters, _actors)
    assert port_out == jax_out
    assert port_out["order"] == list(range(6, 16))
    assert port_out["killed"] == ("raised", "ActorDiedError")


def test_a_dead_workers_task_leases_come_back(clusters):
    """An actor killed while it holds leases for its own tasks (a train
    worker that streamed its dataset shard, killed by ``fit()``'s
    teardown) gives their CPUs back, as an exiting driver's leases do.
    The JAX package's GCS keeps them, and its cluster is left without
    CPUs."""
    rt = ray_tpu_torch

    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    class Submitter:
        def go(self, n):
            return sum(rt.get([inc.remote(i) for i in range(n)]))

    total = rt.cluster_resources()["CPU"]
    a = Submitter.remote()
    assert rt.get(a.go.remote(40)) == sum(range(1, 41))
    rt.kill(a)
    deadline = time.time() + 20
    while rt.available_resources().get("CPU", 0.0) < total:
        assert time.time() < deadline, rt.available_resources()
        time.sleep(0.1)


# -------------------------------------------------- placement groups


def _placement_groups(rt):
    util = __import__(rt.__name__ + ".util", fromlist=["util"])
    pg = util.placement_group([{"CPU": 1}, {"CPU": 1}], strategy="PACK")
    ready = pg.wait(10)

    @rt.remote
    def where():
        return os.getpid()

    pids = rt.get([
        where.options(scheduling_strategy=util.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in range(2)])
    row = util.placement_group_table()[pg.id.hex()]
    infeasible = util.placement_group([{"CPU": 1000}], strategy="PACK")
    out = {"ready": ready, "ran": len(pids),
           "table_keys": sorted(row),
           "bundles": row.get("bundles"),
           "infeasible": infeasible.wait(0.5)}
    util.remove_placement_group(infeasible)
    util.remove_placement_group(pg)
    return out


def test_placement_groups_match(clusters):
    jax_out, port_out = _both(clusters, _placement_groups)
    assert port_out == jax_out
    assert port_out["ready"] and not port_out["infeasible"]


# ------------------------------------------------------------ resources


def test_resource_keys_match(clusters):
    jax_out, port_out = _both(
        clusters, lambda rt: (sorted(rt.cluster_resources()),
                              sorted(rt.nodes()[0])))
    assert port_out == jax_out
    assert ray_tpu_torch.cluster_resources()["GPU"] == GPUS


def _gpu_task(rt, res):
    @rt.remote(**res)
    def visible():
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")

    return rt.get(visible.remote(), timeout=60)


def test_gpu_task_is_pinned_to_its_card(clusters):
    """C3's first fix. The port's worker sees exactly one card; the JAX
    package's reads ``[]`` (its ``set_visible_accelerators`` has no
    caller), which this test records as the reference's fault."""
    ids, env = _gpu_task(clusters["port"], {"num_gpus": 1})
    assert len(ids) == 1 and ids[0] in ("0", "1")
    assert env == ids[0]
    jax_ids, jax_env = _gpu_task(clusters["jax"],
                                 {"resources": {"GPU": 1}})
    assert jax_ids == [] and jax_env is None  # C3 in the reference


def test_fractional_gpus_share_one_card(clusters):
    rt = clusters["port"]

    @rt.remote(num_gpus=0.5)
    class Rank:
        def ids(self):
            return rt.get_gpu_ids()

    ranks = [Rank.remote() for _ in range(2)]
    ids = rt.get([r.ids.remote() for r in ranks], timeout=60)
    assert ids[0] == ids[1] and len(ids[0]) == 1
    for r in ranks:
        rt.kill(r)


def test_gpu_request_beyond_the_node_stays_pending(clusters):
    """No fallback: a request for more GPUs than the node has waits (as a
    TPU request does in the JAX package); it never runs on the CPU."""
    rt = clusters["port"]

    @rt.remote(num_gpus=GPUS + 1)
    def never():
        return "ran"

    ref = never.remote()
    ready, pending = rt.wait([ref], num_returns=1, timeout=1.0)
    assert ready == [] and pending == [ref]
    rt.cancel(ref, force=True)


def _wait_gpus_free(rt, want=GPUS, timeout=30.0):
    """Wait until every card's share is back in the pool."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if abs(rt.available_resources().get("GPU", 0.0) - want) < 1e-6:
            return
        time.sleep(0.05)
    raise AssertionError(f"GPUs free: {rt.available_resources()}")


def _share_actor(rt):
    @rt.remote
    class Share:
        def ids(self):
            return rt.get_gpu_ids()

    return Share


def test_a_fraction_that_fits_no_card_stays_pending(clusters):
    """Three 0.6 shares on two cards: 0.8 GPUs stay free in all, but no
    card can take a third 0.6, so it waits for one."""
    rt = clusters["port"]
    share = _share_actor(rt)
    actors = [share.options(num_gpus=0.6).remote() for _ in range(3)]
    refs = [a.ids.remote() for a in actors]
    ready, pending = rt.wait(refs, num_returns=3, timeout=2.0)
    assert len(ready) == 2 and len(pending) == 1
    assert sorted(rt.get(r)[0] for r in ready) == ["0", "1"]
    rt.kill(actors[refs.index(pending[0])])
    for r in ready:
        rt.kill(actors[refs.index(r)])
    _wait_gpus_free(rt)


def test_split_cards_refuse_a_whole_gpu(clusters):
    """Cards split by shares: 1.1 GPUs free in all and no card whole.
    A ``num_gpus=1`` task waits until a card is whole, then gets it."""
    rt = clusters["port"]
    share = _share_actor(rt)
    a, b = (share.options(num_gpus=0.6).remote() for _ in range(2))
    ids_a, ids_b = rt.get([a.ids.remote(), b.ids.remote()], timeout=60)
    assert ids_a != ids_b
    c = share.options(num_gpus=0.3).remote()
    ids_c = rt.get(c.ids.remote(), timeout=60)
    rt.kill(a if ids_a == ids_c else b)  # the card c shares: 0.7 free
    _wait_gpus_free(rt, want=1.1)

    @rt.remote(num_gpus=1)
    def whole():
        return rt.get_gpu_ids(), os.environ.get("CUDA_VISIBLE_DEVICES")

    ref = whole.remote()
    ready, _ = rt.wait([ref], num_returns=1, timeout=1.0)
    assert ready == []
    rt.kill(c)
    assert rt.get(ref, timeout=60) == (ids_c, ids_c[0])
    rt.kill(b if ids_a == ids_c else a)
    _wait_gpus_free(rt)


def test_placement_group_reserves_its_cards(clusters):
    """A group's GPU bundles hold their cards: two 0.5 bundles share one
    card, pinned to it; a whole-card task takes the other; a group whose
    bundles fit no card waits."""
    rt = clusters["port"]
    util = ray_tpu_torch.util
    pg = util.placement_group([{"CPU": 1, "GPU": 0.5}] * 2)
    assert pg.wait(10)

    @rt.remote(num_cpus=1, num_gpus=0.5)
    def ids():
        return rt.get_gpu_ids()

    in_group = rt.get([ids.options(
        scheduling_strategy=util.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=i)).remote()
        for i in range(2)], timeout=60)
    assert in_group[0] == in_group[1] and len(in_group[0]) == 1
    other = rt.get(ids.options(num_gpus=1).remote(), timeout=60)
    assert len(other) == 1 and other != in_group[0]
    too_big = util.placement_group([{"GPU": 0.6}] * 2)
    assert not too_big.wait(1.0)  # one card free, and 0.6 + 0.6 > 1
    util.remove_placement_group(too_big)
    util.remove_placement_group(pg)
    _wait_gpus_free(rt)
    three = util.placement_group([{"GPU": 0.6}] * 3)
    assert not three.wait(1.0)  # 1.8 of 2 GPUs, but no card takes two
    util.remove_placement_group(three)


def test_a_gpu_count_above_one_must_be_whole(clusters):
    """C5: ``num_gpus=1.5`` would pin two whole cards but charge 1.5, so
    the port refuses it where the options resolve, as upstream Ray does;
    the JAX package (no ``num_gpus``) takes ``resources={"GPU": 1.5}``."""
    rt = clusters["port"]
    share = _share_actor(rt)
    with pytest.raises(ValueError, match="whole"):
        share.options(num_gpus=1.5)
    with pytest.raises(ValueError, match="whole"):
        rt.remote(num_gpus=2.5)(lambda: 0)
    for ok in (0.5, 1, 2):
        share.options(num_gpus=ok)
    _share_actor(clusters["jax"]).options(resources={"GPU": 1.5})


@pytest.mark.parametrize("free,want,pick", [
    ({"0": 0.4, "1": 0.4, "2": 0.4, "3": 0.4}, 1.0, None),
    ({"0": 0.4, "1": 0.4, "2": 0.4, "3": 0.4}, 0.6, None),
    ({"0": 0.4, "1": 0.7, "2": 1.0}, 0.4, ["0"]),
    ({"0": 0.4, "1": 0.7, "2": 1.0}, 0.5, ["1"]),
    ({"0": 0.4, "1": 1.0, "2": 1.0}, 2.0, ["1", "2"]),
    ({"0": 0.4, "1": 1.0, "2": 1.0}, 3.0, None),
])
def test_gpu_pick_places_a_request_or_refuses_it(free, want, pick):
    """A fraction takes the fullest card it fits on, a whole count that
    many whole cards, and a request no card can take gets None."""
    from ray_tpu_torch._private.gcs import _gpu_pick

    assert _gpu_pick(free, want) == pick


# ------------------------------------------------------------ tensors


def _tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "fp32": torch.randn(64, 33, generator=g),
        "bf16": torch.randn(17, 8, generator=g).to(torch.bfloat16),
        "int64": torch.randint(-2**40, 2**40, (100,), generator=g),
        "large": torch.randn(2048, 1024, generator=g),  # 8 MiB of fp32
    }


def _same_bits(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                        else a, b.view(torch.int16)
                        if b.dtype == torch.bfloat16 else b))


def test_cpu_tensors_round_trip_bit_for_bit(clusters):
    rt = clusters["port"]
    ts = _tensors()
    assert ts["large"].numel() * 4 >= 8 << 20
    back = rt.get(rt.put(ts))
    assert all(_same_bits(ts[k], back[k]) for k in ts)

    @rt.remote
    def echo(x):
        return x

    through = rt.get(echo.remote(ts))
    assert all(_same_bits(ts[k], through[k]) for k in ts)


def test_large_tensor_arrives_without_a_copy(clusters):
    """A worker's ``get`` of an 8 MiB tensor is a view of the port's
    arena: two gets share one address, which lies in a ``/dev/shm``
    mapping of the port's own (``rtpt``) arena."""
    rt = clusters["port"]
    t = _tensors()["large"]
    ref = rt.put(t)

    @rt.remote
    def inspect(refs):
        a, b = rt.get(refs[0]), rt.get(refs[0])
        addr = a.data_ptr()
        in_arena = False
        with open("/proc/self/maps") as f:
            for line in f:
                span, *rest = line.split()
                lo, hi = (int(x, 16) for x in span.split("-"))
                if lo <= addr < hi:
                    in_arena = "/dev/shm/rtpt" in line
        return (addr == b.data_ptr(), in_arena, float(a.sum()),
                a.dtype == torch.float32)

    same, in_arena, total, fp32 = rt.get(inspect.remote([ref]), timeout=60)
    assert same and in_arena and fp32
    assert total == float(t.sum())


# ------------------------------------------------------------ import rule


def test_port_worker_and_head_load_no_jax(clusters):
    """A worker's ``sys.modules`` and the head's import log hold no
    ``ray_tpu``, ``jax`` or ``ml_dtypes`` module (nor, on the head, torch)."""
    rt = clusters["port"]

    @rt.remote
    def loaded():
        import sys

        return sorted(sys.modules)

    mods = rt.get(loaded.remote(), timeout=60)
    assert "ray_tpu_torch._private.worker_main" in mods

    def bad(name):
        top = name.split(".")[0]
        return top in ("ray_tpu", "jax", "jaxlib", "ml_dtypes")

    assert not [m for m in mods if bad(m)]
    session_dir = os.path.join(clusters["root"], clusters["session"])
    with open(os.path.join(session_dir, "gcs.out")) as f:
        log = f.read()
    head = [line.rsplit("|", 1)[-1].strip() for line in log.splitlines()
            if line.startswith("import time:") and "|" in line]
    assert "ray_tpu_torch._private.gcs" in head
    assert not [m for m in head if bad(m)]
    assert "torch" not in head  # the control plane never loads torch


# ------------------------------------------------------------ the copies

REPO = Path(__file__).resolve().parents[1]
# Modules copied from the reference with only their names changed (the
# package, the RAY_TPU_ environment prefix and the rtpu arena prefix):
# their code, comments and docstrings aside (which drop the reference's
# history notes), is the renamed reference's. The rest differ as
# CHANGES.md lists, module by module.
VERBATIM = (
    "_private/agent_entry.py", "_private/backoff.py",
    "_private/broadcast.py", "_private/config.py", "_private/failpoints.py",
    "_private/gcs_persistence.py", "_private/gcs_shards.py",
    "_private/head_entry.py", "_private/ids.py",
    "_private/memory_monitor.py", "_private/object_store.py",
    "_private/protocol.py", "_private/pubsub.py",
    "_private/runtime_context.py", "_private/slo.py",
    "_private/thread_check.py", "accelerators/accelerator.py",
    "util/scheduling_strategies.py",
    "util/metrics.py", "util/tracing.py", "util/state.py",
    "util/events.py", "util/pubsub.py", "serve/batching.py",
    "serve/multiplex.py", "serve/ingress.py", "serve/rpc_client.py",
    "serve/config_file.py", "serve/deployment.py", "serve/controller.py",
    "serve/proxy.py", "dag/__init__.py", "dag/compiled.py",
    "util/chaos.py", "util/invariants.py", "train/session.py")


def _renamed(text: str) -> str:
    text = re.sub(r"\bray_tpu\b(?!_torch)", "ray_tpu_torch", text)
    text = re.sub(r"\bRAY_TPU_(?!TORCH_)", "RAY_TPU_TORCH_", text)
    return re.sub(r"\brtpu", "rtpt", text)


def _code(text: str) -> str:
    """The module's syntax tree without docstrings (comments are not in
    it)."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body[0] = ast.Pass()
    return ast.dump(tree)


@pytest.mark.parametrize("module", VERBATIM + ("native/shm_store.cc",))
def test_runtime_copy_is_the_reference_code_but_for_names(module):
    ref = REPO / ("native/shm_store.cc" if module.endswith(".cc")
                  else f"ray_tpu/{module}")
    got = (REPO / "ray_tpu_torch" / module).read_text()
    want = _renamed(ref.read_text())
    if module.endswith(".cc"):
        assert got == want
    else:
        assert _code(got) == _code(want)


# ------------------------------------------------------------ GCS restart


def _restart_port_gcs():
    """Crash-restart the port's control plane in place, as
    ``tests/test_gcs_fault_tolerance.py`` restarts the reference's, and
    wait for this driver to reconnect."""
    from ray_tpu_torch._private.worker import global_worker

    w = global_worker()
    epoch = w._gcs_epoch
    assert w.request_gcs({"t": "gcs_restart"}, timeout=10).get("ok")
    deadline = time.time() + 20
    # the dying instance may still answer a request for a few ms: wait
    # for the reconnect to the new one
    while w._gcs_epoch == epoch:
        assert time.time() < deadline, "driver did not reconnect"
        time.sleep(0.05)
    w.cluster_info()


def test_restarted_gcs_keeps_its_workers_cards(clusters):
    """C1. Two 0.7 actors hold one card each: 0.6 GPUs stay free in all,
    but no card has 0.5 free. After a GCS restart the surviving workers
    report their cards in their resync hello, so a 0.5 request still
    waits (the restarted GCS had forgotten the cards, and pinned it to a
    card an actor uses), and is admitted on the card of the actor that is
    killed. Runs last: it restarts the module's port cluster."""
    rt = clusters["port"]
    share = _share_actor(rt)
    held = [share.options(num_gpus=0.7).remote() for _ in range(2)]
    ids = rt.get([a.ids.remote() for a in held], timeout=60)
    assert sorted(i[0] for i in ids) == ["0", "1"]
    _restart_port_gcs()
    assert rt.get([a.ids.remote() for a in held], timeout=60) == ids
    deadline = time.time() + 20
    while abs(rt.available_resources().get("GPU", 0.0) - 0.6) > 1e-6:
        assert time.time() < deadline, rt.available_resources()
        time.sleep(0.05)  # the workers' resync re-charges their shares
    late = share.options(num_gpus=0.5).remote()
    ref = late.ids.remote()
    ready, _ = rt.wait([ref], num_returns=1, timeout=2.0)
    assert ready == []
    rt.kill(held[1])
    assert rt.get(ref, timeout=60) == ids[1]
    for a in (held[0], late):
        rt.kill(a)
    _wait_gpus_free(rt)


def test_restored_bundle_keeps_the_card_its_actor_uses(clusters):
    """C1 for placement groups: a restarted GCS places the groups it
    restores once the adoption window closes, taking for each bundle the
    cards its surviving actors report. The bundle's actor runs on card 1
    (card 0 was busy when the group was made); after the restart a whole
    card goes to card 0, not to the card the actor still uses."""
    rt = clusters["port"]
    util = ray_tpu_torch.util
    share = _share_actor(rt)
    busy = share.options(num_gpus=0.7).remote()
    assert rt.get(busy.ids.remote(), timeout=60) == ["0"]
    pg = util.placement_group([{"GPU": 0.5}])
    assert pg.wait(10)
    member = share.options(
        num_gpus=0.5, scheduling_strategy=util.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)).remote()
    assert rt.get(member.ids.remote(), timeout=60) == ["1"]
    rt.kill(busy)
    _wait_gpus_free(rt, want=1.5)
    _restart_port_gcs()
    assert rt.get(member.ids.remote(), timeout=60) == ["1"]
    deadline = time.time() + 30
    while util.placement_group_table()[pg.id.hex()]["state"] != "ready":
        assert time.time() < deadline, "the group was not placed again"
        time.sleep(0.1)

    @rt.remote(num_gpus=1)
    def whole():
        return rt.get_gpu_ids()

    assert rt.get(whole.remote(), timeout=60) == ["0"]
    rt.kill(member)
    util.remove_placement_group(pg)
    _wait_gpus_free(rt)
