"""The port's ``workflow`` against the JAX package's, on the CPU.

One module-scoped cluster of each package. Each scenario of
``tests/test_workflow.py`` runs on both packages at once, each over its
own storage root, and the two give the same outputs, statuses,
checkpointed steps and step re-execution counts: a run and its output, a
resume after a failed step that does not run the finished step again,
inputs, ``run_async``, ``wait_for_event`` over the package's pubsub and
its resume, a durable sleep, ``continuation``, named and unsaved steps,
``cancel`` and ``list_all``/``delete``.

Remote functions are defined inside the scenarios, so cloudpickle ships
them by value and no port worker imports this module (which imports JAX).
The fixture shuts both clusters down and removes the port's arenas and
session directory, failures included.
"""

import glob
import importlib
import json
import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

import ray_tpu
import ray_tpu_torch


@pytest.fixture(scope="module")
def clusters():
    base = tempfile.gettempdir()
    root = tempfile.mkdtemp(prefix="rtw", dir=base if len(base) < 48
                            else "/tmp")
    saved = os.environ.get("RAY_TPU_TORCH_TMPDIR")
    os.environ["RAY_TPU_TORCH_TMPDIR"] = root
    session = None
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        ray_tpu.init(num_cpus=4, probe_tpu=False, ignore_reinit_error=True)
        ray_tpu_torch.init(num_cpus=4, probe_gpu=False)
        session = ray_tpu_torch._private.worker.global_worker().session_name
        yield {"jax": ray_tpu, "port": ray_tpu_torch}
    finally:
        if saved is None:
            os.environ.pop("RAY_TPU_TORCH_TMPDIR", None)
        else:
            os.environ["RAY_TPU_TORCH_TMPDIR"] = saved
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for p in glob.glob("/dev/shm/rtpt*"):
                if session and session[-8:] in p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            shutil.rmtree(root, ignore_errors=True)


def _both(clusters, tmp_path, scenario):
    """``scenario(rt, workflow, dag, root)`` on both packages at once, each
    with its workflow storage under ``tmp_path/<side>``: (jax, port)."""
    def run(side):
        rt = clusters[side]
        wf = importlib.import_module(f"{rt.__name__}.workflow")
        dag = importlib.import_module(f"{rt.__name__}.dag")
        root = tmp_path / side
        root.mkdir()
        wf.init(str(root / "wf"))
        return scenario(rt, wf, dag, root)

    with ThreadPoolExecutor(2) as pool:
        jax_f, port_f = (pool.submit(run, s) for s in ("jax", "port"))
        return jax_f.result(), port_f.result()


def _outcome(fn):
    """A value, or the class name of what it raised."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return ("raised", type(e).__name__)


def test_run_output_and_metadata_match(clusters, tmp_path):
    def scenario(rt, wf, dag, root):
        @rt.remote
        def add(a, b):
            return a + b

        @rt.remote
        def mul(a, b):
            return a * b

        out = wf.run(add.bind(mul.bind(3, 3), 1), workflow_id="w_basic")
        meta = wf.get_metadata("w_basic")
        return (out, wf.get_status("w_basic"), wf.get_output("w_basic"),
                meta["checkpointed_steps"], meta["status"],
                _outcome(lambda: wf.get_output("missing")))

    jax_out, port_out = _both(clusters, tmp_path, scenario)
    assert jax_out == port_out
    assert port_out[:3] == (10, "SUCCESSFUL", 10)
    assert port_out[3] == ["0000_mul", "0001_add"]


def test_resume_after_a_failed_step_runs_only_what_failed(clusters,
                                                          tmp_path):
    def scenario(rt, wf, dag, root):
        count = root / "count_a.txt"
        flag = root / "fail_once.flag"
        flag.write_text("fail")

        @rt.remote(max_retries=0)
        def step_a():
            n = int(count.read_text()) if count.exists() else 0
            count.write_text(str(n + 1))
            return 5

        @rt.remote(max_retries=0)
        def step_b(x):
            if flag.exists():
                raise RuntimeError("transient failure")
            return x * 2

        node = step_b.bind(step_a.bind())
        first = _outcome(lambda: wf.run(node, workflow_id="w_resume"))
        status = wf.get_status("w_resume")
        steps = wf.get_metadata("w_resume")["checkpointed_steps"]
        flag.unlink()
        out = wf.resume("w_resume")
        return (first, status, steps, out, wf.get_status("w_resume"),
                count.read_text(), wf.resume("w_resume"))

    jax_out, port_out = _both(clusters, tmp_path, scenario)
    assert jax_out == port_out
    assert port_out == (("raised", "RuntimeError"), "FAILED",
                        ["0000_step_a"], 10, "SUCCESSFUL", "1", 10)


def test_inputs_async_and_sleep_match(clusters, tmp_path):
    def scenario(rt, wf, dag, root):
        @rt.remote
        def add(a, b):
            return a + b

        @rt.remote
        def mul(a, b):
            return a * b

        with dag.InputNode() as inp:
            node = mul.bind(add.bind(inp, 1), 3)
        ran = wf.run(node, workflow_id="w_inp", args=(4,))
        again = wf.resume("w_inp")
        fut = wf.run_async(add.bind(20, 22), workflow_id="w_async")
        async_out = (fut.result(timeout=60), fut.workflow_id)
        t0 = time.time()
        slept = wf.run(wf.sleep(0.2), workflow_id="w_sleep")
        took = time.time() - t0
        t1 = time.time()
        resumed = wf.resume("w_sleep")
        quick = time.time() - t1 < 0.15
        later = (wf.resume_async("w_sleep").result(timeout=30),
                 wf.get_output_async("w_sleep").result(timeout=30))
        return (ran, again, async_out, wf.get_status("w_async"), slept,
                took >= 0.2, resumed, quick, later)

    jax_out, port_out = _both(clusters, tmp_path, scenario)
    assert jax_out == port_out
    assert port_out == (15, 15, (42, "w_async"), "SUCCESSFUL", None, True,
                        None, True, (None, None))


def test_wait_for_event_and_its_resume_match(clusters, tmp_path):
    def scenario(rt, wf, dag, root):
        pubsub = importlib.import_module(f"{rt.__name__}.util.pubsub")
        channel = f"orders_{rt.__name__}"

        @rt.remote
        def combine(evt, tag):
            return {"got": evt["order_id"], "tag": tag}

        node = combine.bind(wf.wait_for_event(channel, timeout=60), "done")

        def publish_soon():
            for _ in range(100):
                if pubsub.publish(channel, {"order_id": 42}) > 0:
                    return
                time.sleep(0.2)

        t = threading.Thread(target=publish_soon, daemon=True)
        t.start()
        out = wf.run(node, workflow_id="evt_wf")
        t.join()
        t0 = time.time()
        again = wf.resume("evt_wf")
        return (out, again, time.time() - t0 < 10,
                wf.get_metadata("evt_wf")["checkpointed_steps"])

    jax_out, port_out = _both(clusters, tmp_path, scenario)
    assert jax_out == port_out
    assert port_out == ({"got": 42, "tag": "done"},
                        {"got": 42, "tag": "done"}, True,
                        ["0000__wait_for_event", "0001_combine"])


def test_continuation_options_and_errors_match(clusters, tmp_path):
    def scenario(rt, wf, dag, root):
        @rt.remote
        def second(x):
            return x * 10

        @rt.remote
        def first():
            return wf.continuation(second.bind(4))

        @rt.remote
        def a():
            return 1

        @rt.remote
        def b(x):
            return x + 1

        cont = wf.run(first.bind(), workflow_id="w_cont")
        cont_steps = wf.get_metadata("w_cont")["checkpointed_steps"]
        cont_again = wf.resume("w_cont")
        named = wf.options(name="step_a")(a.bind())
        node = wf.options(name="step_b", checkpoint=False)(b.bind(named))
        opts = wf.run(node, workflow_id="w_opts")
        opt_steps = wf.get_metadata("w_opts")["checkpointed_steps"]
        broken = root / "wf" / "w_broken"
        broken.mkdir()
        (broken / "status.json").write_text(json.dumps(
            {"workflow_id": "w_broken", "status": "FAILED"}))
        return (cont, cont_steps, cont_again, opts, opt_steps,
                _outcome(lambda: wf.resume("w_broken")),
                _outcome(lambda: wf.continuation(5)),
                issubclass(wf.WorkflowExecutionError, wf.WorkflowError))

    jax_out, port_out = _both(clusters, tmp_path, scenario)
    assert jax_out == port_out
    assert port_out[0] == 40 and port_out[2] == 40 and port_out[3] == 2
    assert any(s.startswith("g1_") for s in port_out[1])
    assert port_out[4] == ["step_a"]
    assert port_out[5] == ("raised", "WorkflowExecutionError")
    assert port_out[6] == ("raised", "TypeError") and port_out[7]


def test_cancel_list_all_and_delete_match(clusters, tmp_path):
    """A long workflow cancelled from another thread stops before its next
    step and is CANCELED; resume then finishes it from its checkpoints.
    ``list_all`` lists every stored workflow with its status, and
    ``resume_all`` resumes the ones that did not succeed."""
    def scenario(rt, wf, dag, root):
        runs = root / "runs.txt"

        @rt.remote
        def slow(x):
            import time

            with open(runs, "a") as f:
                f.write(f"{x}\n")
            time.sleep(0.5)
            return x + 1

        @rt.remote
        def add(a, b):
            return a + b

        node = slow.bind(slow.bind(slow.bind(slow.bind(0))))
        fut = wf.run_async(node, workflow_id="w_cancel")
        while not runs.exists():
            time.sleep(0.02)
        wf.cancel("w_cancel")
        cancelled = _outcome(lambda: fut.result(timeout=60))
        status = wf.get_status("w_cancel")
        before = len(runs.read_text().split())
        wf.run(add.bind(1, 2), workflow_id="w_list_1")
        wf.run(add.bind(3, 4), workflow_id="w_list_2")
        listed = sorted((w["workflow_id"], w["status"])
                        for w in wf.list_all())
        resumed = wf.resume_all()
        after = runs.read_text().split()
        wf.delete("w_list_1")
        return (cancelled, status, before, listed, resumed,
                wf.get_output("w_cancel"), len(after),
                sorted(w["workflow_id"] for w in wf.list_all()),
                _outcome(lambda: wf.get_status("w_list_1")))

    jax_out, port_out = _both(clusters, tmp_path, scenario)
    assert jax_out == port_out
    (cancelled, status, before, listed, resumed, output, runs, left,
     gone) = port_out
    assert cancelled == ("raised", "WorkflowCanceledError")
    assert status == "CANCELED" and before < 4
    assert listed == [("w_cancel", "CANCELED"), ("w_list_1", "SUCCESSFUL"),
                      ("w_list_2", "SUCCESSFUL")]
    assert resumed == ["w_cancel"] and output == 4 and runs == 4
    assert left == ["w_cancel", "w_list_2"]
    assert gone == ("raised", "ValueError")
