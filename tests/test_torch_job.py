"""The port's job submission, dashboard and CLI against the JAX package's,
on the CPU.

One module-scoped cluster per package runs ``test_job.py``'s,
``test_dashboard.py``'s and ``test_dashboard_profiling.py``'s scenarios,
and each test compares the two packages' statuses, info keys, logs and
endpoints (names aside). The CLI (``python -m ray_tpu_torch``) runs as
subprocesses on a cluster of its own: ``start --num-gpus``, ``status``,
``job submit``, ``job logs`` and ``stop``, which leaves no process or
arena behind; ``check`` waits for ROADMAP A13b, and ``up`` and ``down``
reach the cluster launcher.

Remote functions and job scripts are written inside the scenarios, so no
worker imports this module (which imports JAX).
"""

import ast
import glob
import importlib
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu_torch._private.node import session_leftovers

REPO = Path(__file__).resolve().parents[1]
PACKAGES = {"jax": "ray_tpu", "port": "ray_tpu_torch"}


def _short_root(prefix):
    """A short directory for the port's sessions: UNIX socket paths in it
    must stay under the kernel's 108-byte limit."""
    base = tempfile.gettempdir()
    return tempfile.mkdtemp(prefix=prefix, dir=base if len(base) < 48
                            else "/tmp")


def _plain(value):
    """A value with the port's names turned into the JAX package's."""
    if isinstance(value, str):
        value = re.sub(r"\bray_tpu_torch\b", "ray_tpu", value)
        return re.sub(r"\bRAY_TPU_TORCH_", "RAY_TPU_", value)
    if isinstance(value, dict):
        return {_plain(k): _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    return value


@pytest.fixture(scope="module")
def clusters():
    """One cluster of each package, their sessions under two short roots.
    The reference's dashboard starts a cluster of its own in its worker
    (see test_the_port_dashboard_serves_its_own_cluster), which outlives
    the fixture's: its processes and arena are removed here too."""
    roots = {"RAY_TPU_TORCH_TMPDIR": _short_root("rtj"),
             "RAY_TPU_TMPDIR": _short_root("rjj")}
    prefixes = {"RAY_TPU_TORCH_TMPDIR": "rtpt", "RAY_TPU_TMPDIR": "rtpu"}
    saved = {k: os.environ.get(k) for k in roots}
    os.environ.update(roots)
    # a cluster another module left behind would lack this one's settings
    for rt in (ray_tpu, ray_tpu_torch):
        if rt.is_initialized():
            rt.shutdown()
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=1, probe_gpu=False)
        ray_tpu.init(num_cpus=4, probe_tpu=False, ignore_reinit_error=True)
        yield {"jax": ray_tpu, "port": ray_tpu_torch}
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            for var, root in roots.items():
                pids, segments = session_leftovers(root, var, prefixes[var])
                for pid in pids:
                    try:
                        os.kill(pid, 9)
                    except OSError:
                        pass
                for p in segments:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            for root in roots.values():
                shutil.rmtree(root, ignore_errors=True)


def _both(scenario, *args):
    """``scenario(name, *args)`` on both packages at once: (jax, port)."""
    with ThreadPoolExecutor(2) as pool:
        jax_f, port_f = (pool.submit(scenario, n, *args)
                         for n in ("jax", "port"))
        return jax_f.result(), port_f.result()


def _job(name):
    return importlib.import_module(f"{PACKAGES[name]}.job")


# ------------------------------------------------------------------ jobs


def _jobs(name, tmp_path):
    job = _job(name)
    pkg = PACKAGES[name]
    client = job.JobSubmissionClient()
    py = sys.executable
    out = {}
    jid = client.submit_job(
        entrypoint=f"{py} -c \"print('hello from job')\"")
    out["submit"] = (jid.startswith("raysubmit_"),
                     client.wait_until_finish(jid, timeout=60),
                     "hello from job" in client.get_job_logs(jid))
    out["info_keys"] = sorted(client.get_job_info(jid))
    # a submitted driver connects back through the address variable
    script = tmp_path / f"{name}_job_script.py"
    script.write_text(
        f"import {pkg}\n"
        f"{pkg}.init()\n"
        f"@{pkg}.remote\n"
        "def f(): return 41\n"
        f"print('task says', {pkg}.get(f.remote()) + 1)\n")
    jid = client.submit_job(entrypoint=f"{py} {script}")
    status = client.wait_until_finish(jid, timeout=120)
    logs = client.get_job_logs(jid)
    out["uses_cluster"] = (status, "task says 42" in logs)
    jid = client.submit_job(entrypoint=f"{py} -c 'import sys; sys.exit(3)'")
    out["failing"] = (client.wait_until_finish(jid, timeout=60),
                      client.get_job_info(jid)["message"])
    jid = client.submit_job(
        entrypoint=f"{py} -c 'import time; time.sleep(60)'")
    deadline = time.time() + 10
    while client.get_job_status(jid) != job.RUNNING and \
            time.time() < deadline:
        time.sleep(0.1)
    out["stop"] = (client.stop_job(jid),
                   client.wait_until_finish(jid, timeout=30),
                   client.stop_job(jid))
    jid = client.submit_job(
        entrypoint=f"{py} -c "
                   "'import os; print(\"VAL=\" + os.environ[\"MY_VAR\"])'",
        runtime_env={"env_vars": {"MY_VAR": "xyz"}})
    out["env_vars"] = (client.wait_until_finish(jid, timeout=60),
                       client.get_job_logs(jid))
    jid = client.submit_job(entrypoint=f"{py} -c 'print(1)'",
                            metadata={"owner": "test"})
    client.wait_until_finish(jid, timeout=60)
    jobs = {j["job_id"]: j for j in client.list_jobs()}
    out["list"] = (len(jobs), jobs[jid]["metadata"],
                   jobs[jid]["entrypoint"].endswith("'print(1)'"),
                   sorted(jobs[jid]))
    fixed = client.submit_job(entrypoint=f"{py} -c 'print(1)'",
                              submission_id="fixed_id_1")
    try:
        client.submit_job(entrypoint="true", submission_id="fixed_id_1")
        dup = None
    except Exception as e:  # noqa: BLE001 - the error is the result
        dup = (type(e).__name__, "already exists" in str(e))
    out["duplicate"] = (fixed, dup)
    out["tail"] = list(client.tail_job_logs(fixed))
    return _plain(out)


def test_jobs_give_the_same_statuses_info_and_logs(clusters, tmp_path):
    jax_out, port_out = _both(_jobs, tmp_path)
    assert jax_out == port_out
    assert port_out["submit"] == (True, "SUCCEEDED", True)
    assert port_out["info_keys"] == [
        "end_time", "entrypoint", "job_id", "log_path", "message",
        "metadata", "start_time", "status"]
    assert port_out["uses_cluster"] == ("SUCCEEDED", True)
    assert port_out["failing"] == ("FAILED", "exit code 3")
    assert port_out["stop"] == (True, "STOPPED", False)
    assert port_out["env_vars"] == ("SUCCEEDED", "VAL=xyz\n")
    assert port_out["list"][1:3] == ({"owner": "test"}, True)
    assert port_out["duplicate"] == ("fixed_id_1", ("ValueError", True))
    assert "".join(port_out["tail"]) == "1\n"


# ------------------------------------------------------------- dashboard


@pytest.fixture(scope="module")
def dashboards(clusters):
    pytest.importorskip("aiohttp")
    urls = {}
    try:
        for name, pkg in PACKAGES.items():
            dash = importlib.import_module(f"{pkg}.dashboard")
            urls[name] = dash.start_dashboard(port=0)
        yield urls
    finally:
        for name in urls:
            importlib.import_module(
                f"{PACKAGES[name]}.dashboard").stop_dashboard()


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read().decode(), r.headers.get("content-type", "")


def _get_json(url):
    return json.loads(_get(url)[0])


def _post_json(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _endpoints(name, url):
    rt = ray_tpu if name == "jax" else ray_tpu_torch
    pkg = PACKAGES[name]
    out = {}
    body, ctype = _get(url + "/")
    out["index"] = (f"{pkg} dashboard" in body, "text/html" in ctype)
    out["healthz"] = _get(url + "/healthz")[0]
    c = _get_json(url + "/api/cluster")
    out["cluster"] = (sorted(c), c["num_nodes"], c["resources"]["CPU"])
    nodes = _get_json(url + "/api/nodes")
    out["nodes"] = (len(nodes), nodes[0]["alive"])

    @rt.remote
    def work(x):
        return x + 1

    @rt.remote
    class Pinger:
        def ping(self):
            return "pong"

    p = Pinger.options(name="dash_pinger").remote()
    out["activity"] = (rt.get(p.ping.remote()),
                       rt.get([work.remote(i) for i in range(3)]))
    out["actors"] = any(a.get("name") == "dash_pinger"
                        for a in _get_json(url + "/api/actors"))
    out["task_summary"] = any(
        "work" in n for n in _get_json(url + "/api/task_summary"))
    rt.kill(p)
    mj = _get_json(url + "/api/metrics")
    prom, _ = _get(url + "/metrics")
    out["metrics"] = (isinstance(mj, list), "# TYPE" in prom)
    jid = _post_json(url + "/api/jobs", {
        "entrypoint": f"{sys.executable} -c \"print('dash-job-ran')\"",
        "metadata": {"via": "dashboard"}})["job_id"]
    deadline = time.time() + 60
    while time.time() < deadline:
        info = _get_json(url + f"/api/jobs/{jid}")
        if info.get("status") in ("SUCCEEDED", "FAILED", "STOPPED"):
            break
        time.sleep(0.3)
    out["job"] = (info["status"], info["metadata"],
                  _get_json(url + f"/api/jobs/{jid}/logs")["logs"],
                  any(j["job_id"] == jid
                      for j in _get_json(url + "/api/jobs")))
    jid = _post_json(url + "/api/jobs", {
        "entrypoint": f"{sys.executable} -c 'import time; "
                      f"time.sleep(60)'"})["job_id"]
    out["job_stop"] = (_post_json(url + f"/api/jobs/{jid}/stop", {}),
                       _get_json(url + f"/api/jobs/{jid}")["status"])
    files = _get_json(url + "/api/logs")
    one = _get_json(url + "/api/logs/" + files[0]["name"])
    out["logs"] = (any(f["name"].endswith(".out") for f in files),
                   "lines" in one)
    board = _get_json(url + "/api/grafana_dashboard")
    out["grafana"] = (board["title"], len({p["id"] for p in board["panels"]})
                      == len(board["panels"]))
    out["usage"] = isinstance(_get_json(url + "/api/usage"), dict)
    out["events"] = isinstance(_get_json(url + "/api/events"), list)
    out["profile"] = sorted(_get_json(url + "/api/profile?pid=1"))
    return _plain(out)


def test_dashboard_endpoints_match(dashboards):
    jax_out, port_out = _both(lambda n: _endpoints(n, dashboards[n]))
    assert jax_out == port_out
    assert port_out["index"] == (True, True)
    assert port_out["healthz"] == "ok"
    assert port_out["cluster"][1] == 1 and port_out["nodes"] == (1, True)
    assert port_out["activity"] == ("pong", [1, 2, 3])
    assert port_out["actors"] and port_out["task_summary"]
    assert port_out["metrics"] == (True, True)
    assert port_out["job"] == ("SUCCEEDED", {"via": "dashboard"},
                               "dash-job-ran\n", True)
    assert port_out["job_stop"] == ({"stopped": True}, "STOPPED")
    assert port_out["logs"] == (True, True)
    assert port_out["grafana"] == ("ray_tpu cluster", True)
    assert port_out["profile"] == ["cluster_pids", "error"]


def test_the_port_dashboard_serves_its_own_cluster(dashboards):
    """The port's dashboard runs jobs on the cluster it serves, whose node
    offers the GPU its UI counts. The reference's JobSubmissionClient
    starts a cluster of its own in the dashboard's worker (is_initialized()
    is False there), so a job posted to its dashboard is not one its
    driver's client knows."""
    body, _ = _get(dashboards["port"] + "/")
    assert "c.resources.GPU" in body and "TPU" not in body

    def scenario(name):
        url = dashboards[name]
        jid = _post_json(url + "/api/jobs", {
            "entrypoint": f"{sys.executable} -c 'print(2)'"})["job_id"]
        client = _job(name).JobSubmissionClient()
        try:
            status = client.wait_until_finish(jid, timeout=60)
        except ValueError as e:
            status = type(e).__name__
        return (status, _get_json(url + "/api/cluster")["resources"].get(
            "GPU"), _get_json(url + "/api/cluster")["num_nodes"])

    assert scenario("port") == ("SUCCEEDED", 1.0, 1)
    assert scenario("jax")[0] == "ValueError"


def _grafana_against_live_metrics(name, url):
    """Every metric a core Grafana panel names is one /metrics exports
    (test_dashboard.py), and a user gauge gets a panel of its own
    (test_dashboard_profiling.py)."""
    rt = ray_tpu if name == "jax" else ray_tpu_torch
    pkg = PACKAGES[name]
    grafana = importlib.import_module(f"{pkg}.dashboard.grafana")
    metrics = importlib.import_module(f"{pkg}.util.metrics")

    @rt.remote
    def tick():
        return 1

    assert rt.get([tick.remote() for _ in range(3)]) == [1, 1, 1]
    g = metrics.Gauge(f"{name}_custom_gauge", description="x")
    g.set(42.0)
    time.sleep(1.2)  # the metric push flushes
    prom, _ = _get(url + "/metrics")
    exported = set(re.findall(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{.*\})? ",
                              prom, re.MULTILINE))
    exported |= set(re.findall(r"^# (?:HELP|TYPE) (\S+)", prom,
                               re.MULTILINE))
    missing = [(title, n) for title, expr, _ in grafana._CORE_PANELS
               for n in set(re.findall(r"[a-zA-Z_:][a-zA-Z0-9_:]*", expr))
               if n not in ("rate", "m") and n not in exported]
    dash = grafana.generate_dashboard()
    dash2 = grafana.generate_dashboard(extra_metrics=[f"{name}_gauge"])
    return (missing, [p["title"] for p in dash["panels"]][:12],
            any(p["title"] == f"{name}_gauge" for p in dash2["panels"]),
            dash["schemaVersion"], bool(exported))


def test_grafana_panels_name_live_metrics(dashboards):
    jax_out, port_out = _both(
        lambda n: _grafana_against_live_metrics(n, dashboards[n]))
    assert jax_out == port_out
    missing, titles, user_panel, schema, exported = port_out
    assert missing == [] and exported and user_panel and schema >= 30
    assert "Tasks finished" in titles


def _memdump(name):
    rt = ray_tpu if name == "jax" else ray_tpu_torch
    worker = importlib.import_module(f"{PACKAGES[name]}._private.worker")

    @rt.remote
    class A:
        def pid(self):
            import os

            return os.getpid()

    a = A.remote()
    pid = rt.get(a.pid.remote())
    w = worker.global_worker()
    reply = w.run_async(w.gcs.request(
        {"t": "worker_memdump", "pid": pid}), timeout=35)
    bad = w.run_async(w.gcs.request(
        {"t": "worker_memdump", "pid": 999999}), timeout=35)
    rt.kill(a)
    return (bool(reply.get("ok")), reply["pid"] == pid, reply["rss_kb"] > 0,
            reply["gc_objects"] > 0, bool(bad.get("ok")))


def test_worker_memdump_round_trip_matches(clusters):
    jax_out, port_out = _both(_memdump)
    assert jax_out == port_out == (True, True, True, True, False)


def test_show_in_dashboard_writes_the_worker_message(clusters):
    def scenario(name):
        rt = ray_tpu if name == "jax" else ray_tpu_torch
        worker = importlib.import_module(f"{PACKAGES[name]}._private.worker")
        rt.show_in_dashboard("step 3 of 9", key="probe")
        return worker.global_worker().kv_get("msg:probe", ns="dashboard")

    assert scenario("jax") == scenario("port") == b"step 3 of 9"


# ------------------------------------------------------------------- CLI


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(env, *args, timeout=120):
    return subprocess.run([sys.executable, "-m", "ray_tpu_torch", *args],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


def _cluster_pids(root):
    """Live processes started under this CLI cluster's session root."""
    return session_leftovers(root)[0]


def test_the_cli_starts_runs_a_job_and_stops():
    root = _short_root("rtc")
    env = dict(os.environ, RAY_TPU_TORCH_TMPDIR=root,
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("RAY_TPU_TORCH_ADDRESS", None)
    try:
        start = _cli(env, "start", "--head", "--num-cpus", "2",
                     "--num-gpus", "1", "--port", str(_free_port()))
        assert start.returncode == 0, start.stderr
        assert "ray_tpu_torch head started" in start.stdout
        status = _cli(env, "status")
        assert status.returncode == 0, status.stderr
        assert "  0/1 GPU" in status.stdout and "0/2 CPU" in status.stdout
        submit = _cli(env, "job", "submit", "--", sys.executable, "-c",
                      "print('cli-job-ran')")
        assert submit.returncode == 0, submit.stderr
        jid = re.search(r"submitted job (\S+)", submit.stdout).group(1)
        assert f"job {jid} finished: SUCCEEDED" in submit.stdout
        assert submit.stdout.endswith("cli-job-ran\n")
        assert _cli(env, "job", "logs", jid).stdout == "cli-job-ran\n"
        assert _cli(env, "job", "status", jid).stdout == "SUCCEEDED\n"
        assert jid in _cli(env, "job", "list").stdout
        actors = json.loads(_cli(env, "list", "actors", "--format",
                                 "json").stdout)
        assert [a["name"] for a in actors] == ["_ray_tpu_job_manager"]
        # serve talks to the running cluster: a cluster of its own would
        # leave a second session below
        serve = _cli(env, "serve", "status")
        assert serve.returncode == 0 and serve.stdout == "", serve.stderr
        stop = _cli(env, "stop")
        assert stop.stdout == "cluster stopped\n", stop.stderr
        deadline = time.time() + 30
        while _cluster_pids(root) and time.time() < deadline:
            time.sleep(0.2)
        assert _cluster_pids(root) == []
        sessions = [os.path.basename(s) for s in
                    glob.glob(os.path.join(root, "session_2*"))]
        assert len(sessions) == 1
        assert session_leftovers(root)[1] == []
        assert not os.path.exists(os.path.join(root, "ray_current_cluster"))
    finally:
        for pid in _cluster_pids(root):
            try:
                os.kill(pid, 9)
            except OSError:
                pass
        shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("args", [("check", "ray_tpu_torch"),
                                  ("up", "cluster.yaml"),
                                  ("down", "cluster.yaml")])
def test_the_cli_tooling_commands_wait_for_a13(args, tmp_path):
    """``check`` still waits for the static checks (A13b); ``up`` and
    ``down`` reach the cluster launcher, which refuses a provider it does
    not know before it runs a command (``tests/test_torch_autoscaler.py``
    drives them on a recorded cloud)."""
    env = dict(os.environ, RAY_TPU_TORCH_TMPDIR=str(tmp_path),
               PYTHONPATH=str(REPO))
    config = tmp_path / args[1]
    config.write_text("cluster_name: c\nprovider:\n  type: aws\n")
    out = _cli(env, args[0], str(config) if args[0] != "check" else args[1])
    assert out.returncode != 0
    if args[0] == "check":
        assert "NotImplementedError" in out.stderr
        assert "ROADMAP A13" in out.stderr and args[0] in out.stderr
    else:
        assert "NotImplementedError" not in out.stderr
        assert "launcher provider 'aws' not supported" in out.stderr


# -------------------------------------------------------------- copies

# Copied from the reference with only their names changed; job.py (the
# client in a cluster process, C8), ui.py (GPUs) and scripts.py (GPUs, the
# address file, A13b's check) differ as CHANGES.md lists.
VERBATIM = ("dashboard/__init__.py", "dashboard/head.py",
            "dashboard/grafana.py", "__main__.py")


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
def test_operator_copy_is_the_reference_code_but_for_names(module):
    got = (REPO / "ray_tpu_torch" / module).read_text()
    want = _renamed((REPO / "ray_tpu" / module).read_text())
    assert _code(got) == _code(want)
