"""Dashboard head: detached actor hosting the REST API + UI.

Endpoint map (reference modules in ``python/ray/dashboard/modules/``):
  GET  /                      web UI                 (client/)
  GET  /healthz               liveness               (healthz/)
  GET  /api/cluster           summary cards          (node/, reporter/)
  GET  /api/nodes             node table             (node/)
  GET  /api/workers           worker table           (node/)
  GET  /api/actors            actor table            (actor/)
  GET  /api/tasks             task table             (state/)
  GET  /api/task_summary      per-name state counts  (state_aggregator.py)
  GET  /api/objects           object table           (state/)
  GET  /api/placement_groups  PG table               (state/)
  GET  /api/timeline          chrome-trace events    (``ray timeline``)
  GET  /api/metrics           metric snapshot (JSON) (metrics/)
  GET  /metrics               Prometheus text        (metrics agent)
  GET  /api/jobs              job list               (job/)
  POST /api/jobs              submit {entrypoint}    (job/sdk.py:35)
  GET  /api/jobs/{id}         job info
  GET  /api/jobs/{id}/logs    job driver logs
  POST /api/jobs/{id}/stop    stop job
  GET  /api/logs              session log file list  (log/)
  GET  /api/logs/{name}       one log file's tail
"""

from __future__ import annotations

import os
from typing import Optional

import ray_tpu_torch

DASHBOARD_ACTOR_NAME = "_ray_tpu_dashboard"


class DashboardActor:
    """Runs the aiohttp server inside a worker process (async actor)."""

    def __init__(self):
        self._runner = None
        self._port = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        from aiohttp import web

        from .ui import INDEX_HTML

        app = web.Application()

        def json_api(fn):
            # Handlers block on GCS round-trips (state API uses the worker's
            # IO loop), so they must run on an executor thread, not the
            # event loop serving HTTP.
            import asyncio
            import functools

            async def handler(request):
                loop = asyncio.get_running_loop()
                try:
                    result = await loop.run_in_executor(
                        None, functools.partial(fn, request))
                    return web.json_response(result)
                except Exception as e:  # noqa: BLE001
                    return web.json_response({"error": str(e)}, status=500)
            return handler

        async def index(request):
            return web.Response(text=INDEX_HTML, content_type="text/html")

        async def healthz(request):
            return web.Response(text="ok")

        def cluster(request):
            from ray_tpu_torch.util import state

            nodes = ray_tpu_torch.nodes()
            summary = state.summarize_tasks()
            running = sum(s.get("running", 0) for s in summary.values())
            actors = [a for a in state.list_actors()
                      if a.get("state") == "alive"]
            return {
                "num_nodes": len([n for n in nodes if n["Alive"]]),
                "num_draining": len([n for n in nodes
                                     if n.get("State") == "DRAINING"]),
                "resources": ray_tpu_torch.cluster_resources(),
                "available": ray_tpu_torch.available_resources(),
                "num_actors": len(actors),
                "running_tasks": running,
            }

        def state_ep(kind):
            def ep(request):
                from ray_tpu_torch.util import state

                limit = int(request.query.get("limit", "1000"))
                return getattr(state, f"list_{kind}")(limit)
            return ep

        def task_summary(request):
            from ray_tpu_torch.util import state

            return state.summarize_tasks()

        def timeline(request):
            from ray_tpu_torch.util import state

            return state.timeline()

        def metrics_json(request):
            from ray_tpu_torch.util import state

            return state.list_metrics()

        async def metrics_prom(request):
            import asyncio

            from ray_tpu_torch.util import state

            text = await asyncio.get_running_loop().run_in_executor(
                None, state.prometheus_metrics)
            return web.Response(text=text, content_type="text/plain")

        def jobs_list(request):
            from ray_tpu_torch.job import JobSubmissionClient

            return JobSubmissionClient().list_jobs()

        async def jobs_submit(request):
            import asyncio

            from ray_tpu_torch.job import JobSubmissionClient

            body = await request.json()

            def do():
                return {"job_id": JobSubmissionClient().submit_job(
                    entrypoint=body["entrypoint"],
                    runtime_env=body.get("runtime_env"),
                    metadata=body.get("metadata"))}

            try:
                result = await asyncio.get_running_loop().run_in_executor(
                    None, do)
                return web.json_response(result)
            except Exception as e:  # noqa: BLE001
                return web.json_response({"error": str(e)}, status=500)

        def job_ep(method):
            def ep(request):
                from ray_tpu_torch.job import JobSubmissionClient

                cli = JobSubmissionClient()
                jid = request.match_info["job_id"]
                if method == "info":
                    return cli.get_job_info(jid)
                if method == "logs":
                    return {"logs": cli.get_job_logs(jid)}
                return {"stopped": cli.stop_job(jid)}
            return ep

        def logs_list(request):
            from ray_tpu_torch._private.worker import global_worker

            d = global_worker().session_dir
            out = []
            for name in sorted(os.listdir(d)):
                p = os.path.join(d, name)
                if os.path.isfile(p) and (name.endswith(".out")
                                          or name.endswith(".log")):
                    out.append({"name": name, "size": os.path.getsize(p)})
            return out

        def logs_file(request):
            from ray_tpu_torch._private.worker import global_worker

            name = os.path.basename(request.match_info["name"])
            tail = int(request.query.get("tail", "200"))
            p = os.path.join(global_worker().session_dir, name)
            if not os.path.isfile(p):
                return {"error": "no such log"}
            with open(p, "r", errors="replace") as f:
                lines = f.readlines()
            return {"name": name, "lines": lines[-tail:]}

        def profile(request):
            """On-demand CPU profiling of a cluster process (reference:
            ``dashboard/modules/reporter/profile_manager.py`` py-spy
            drivers). Gated on py-spy being installed; returns a clear
            501-style payload otherwise."""
            import shutil
            import subprocess

            pid = request.query.get("pid")
            if not pid or not pid.isdigit():
                return {"error": "pass ?pid=<process id>"}
            # Only cluster-owned processes may be profiled (the reference
            # profiles known worker PIDs only) — otherwise this endpoint
            # would dump stacks of arbitrary same-user processes.
            from ray_tpu_torch.util import state

            cluster_pids = {w.get("pid") for w in state.list_workers()}
            cluster_pids.add(os.getpid())
            if int(pid) not in cluster_pids:
                return {"error": f"pid {pid} is not a cluster process",
                        "cluster_pids": sorted(p for p in cluster_pids
                                               if p is not None)}
            duration = min(float(request.query.get("duration", "5")), 60.0)
            fmt = request.query.get("format", "speedscope")
            pyspy = shutil.which("py-spy")
            if pyspy is None:
                return {"error": "py-spy is not installed on this host",
                        "install": "pip install py-spy", "supported": False}
            out = subprocess.run(
                [pyspy, "dump", "--pid", pid] if fmt == "dump" else
                [pyspy, "record", "--pid", pid, "-d", str(int(duration)),
                 "-f", fmt, "-o", "/dev/stdout"],
                capture_output=True, text=True, timeout=duration + 30)
            if out.returncode != 0:
                return {"error": out.stderr.strip()[:1000]}
            return {"pid": int(pid), "format": fmt, "profile": out.stdout}

        def trace_api(request):
            """Spans of one trace id (util/tracing.py)."""
            from ray_tpu_torch.util import tracing

            tid = request.query.get("trace_id", "")
            if not tid:
                return {"error": "pass ?trace_id=<32-hex id>"}
            return tracing.get_trace(tid)

        def memory_profile(request):
            """Per-worker memory introspection (reference: memray drivers
            in ``dashboard/modules/reporter/profile_manager.py``).
            Default path needs NO tooling: the worker self-reports RSS,
            gc stats and (when tracing) top tracemalloc sites over its
            control connection. ``?engine=memray`` attaches memray when
            it is installed (gated)."""
            from ray_tpu_torch._private.worker import global_worker
            from ray_tpu_torch.util import state

            pid = request.query.get("pid")
            if not pid or not pid.isdigit():
                return {"error": "pass ?pid=<worker pid>"}
            # Same gate as /api/profile: only cluster-owned pids — attach
            # injects code, strictly more invasive than a stack dump.
            cluster_pids = {w.get("pid") for w in state.list_workers()}
            if int(pid) not in cluster_pids:
                return {"error": f"pid {pid} is not a cluster worker",
                        "cluster_pids": sorted(p for p in cluster_pids
                                               if p is not None)}
            if request.query.get("engine") == "memray":
                import shutil
                import subprocess

                memray = shutil.which("memray")
                if memray is None:
                    return {"error": "memray is not installed on this host",
                            "install": "pip install memray",
                            "supported": False}
                out = subprocess.run(
                    [memray, "attach", pid, "--duration", "5"],
                    capture_output=True, text=True, timeout=60)
                return {"pid": int(pid), "engine": "memray",
                        "output": out.stdout or out.stderr}
            w = global_worker()
            return w.run_async(w.gcs.request(
                {"t": "worker_memdump", "pid": int(pid)}), timeout=35)

        def grafana_dashboard(request):
            """Generated Grafana dashboard JSON for this cluster's
            Prometheus metrics (reference:
            ``modules/metrics/grafana_dashboard_factory.py``)."""
            from .grafana import generate_dashboard

            return generate_dashboard()

        app.router.add_get("/", index)
        app.router.add_get("/api/profile", json_api(profile))
        app.router.add_get("/api/memory", json_api(memory_profile))
        app.router.add_get("/api/grafana_dashboard",
                           json_api(grafana_dashboard))
        app.router.add_get("/api/trace", json_api(trace_api))

        app.router.add_get("/api/events",
                           json_api(state_ep("cluster_events")))

        def usage_api(request):
            from ray_tpu_torch._private.usage import usage_report

            return usage_report()

        app.router.add_get("/api/usage", json_api(usage_api))
        app.router.add_get("/healthz", healthz)
        app.router.add_get("/api/cluster", json_api(cluster))
        for kind in ("nodes", "workers", "actors", "tasks", "objects",
                     "placement_groups"):
            app.router.add_get(f"/api/{kind}", json_api(state_ep(kind)))
        app.router.add_get("/api/task_summary", json_api(task_summary))
        app.router.add_get("/api/timeline", json_api(timeline))
        app.router.add_get("/api/metrics", json_api(metrics_json))
        app.router.add_get("/metrics", metrics_prom)
        app.router.add_get("/api/jobs", json_api(jobs_list))
        app.router.add_post("/api/jobs", jobs_submit)
        app.router.add_get("/api/jobs/{job_id}", json_api(job_ep("info")))
        app.router.add_get("/api/jobs/{job_id}/logs",
                           json_api(job_ep("logs")))
        app.router.add_post("/api/jobs/{job_id}/stop",
                            json_api(job_ep("stop")))
        app.router.add_get("/api/logs", json_api(logs_list))
        app.router.add_get("/api/logs/{name}", json_api(logs_file))

        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, port)
        await site.start()
        self._port = site._server.sockets[0].getsockname()[1]
        return self._port

    async def get_url(self) -> str:
        return f"http://127.0.0.1:{self._port}"

    async def stop(self):
        # Claim-then-await: two concurrent stop()s both passed the old
        # `if self._runner is not None` check before either cleared it
        # across the await — double cleanup() on one runner (RTL141).
        runner, self._runner = self._runner, None
        if runner is not None:
            await runner.cleanup()


def start_dashboard(port: int = 0, host: str = "127.0.0.1") -> str:
    """Start (or return the existing) dashboard; returns its URL."""
    try:
        actor = ray_tpu_torch.get_actor(DASHBOARD_ACTOR_NAME)
        return ray_tpu_torch.get(actor.get_url.remote())
    except ValueError:
        pass
    actor = ray_tpu_torch.remote(DashboardActor).options(
        name=DASHBOARD_ACTOR_NAME, lifetime="detached",
        num_cpus=0).remote()
    actual = ray_tpu_torch.get(actor.start.remote(host, port))
    url = f"http://{host}:{actual}"
    return url


def get_dashboard_url() -> Optional[str]:
    try:
        actor = ray_tpu_torch.get_actor(DASHBOARD_ACTOR_NAME)
        return ray_tpu_torch.get(actor.get_url.remote())
    except ValueError:
        return None


def stop_dashboard():
    try:
        actor = ray_tpu_torch.get_actor(DASHBOARD_ACTOR_NAME)
    except ValueError:
        return
    ray_tpu_torch.get(actor.stop.remote())
    ray_tpu_torch.kill(actor)
