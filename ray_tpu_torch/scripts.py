"""``python -m ray_tpu_torch`` command-line interface.

Analog of the reference's ``ray`` CLI (``python/ray/scripts/scripts.py``):
``start/stop/status/list/summary/timeline/metrics/job/serve``. ``start
--head --num-gpus N`` starts a head whose node offers N GPUs (without it
a subprocess counts the cards); ``start --address HOST:P`` joins a node
agent to it. ``up`` and ``down`` launch and tear down a cluster of GPU VMs
(``autoscaler/launcher.py``); ``check`` waits for the static checks
(ROADMAP A13b).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

def _addr_file() -> str:
    """Where ``start --head`` leaves the address, beside the sessions
    (``RAY_TPU_TORCH_TMPDIR``), where ``init(address="auto")`` reads it."""
    from ray_tpu_torch._private.node import default_session_root

    return os.path.join(default_session_root(), "ray_current_cluster")


def _save_address(address: str):
    os.makedirs(os.path.dirname(_addr_file()), exist_ok=True)
    with open(_addr_file(), "w") as f:
        f.write(address)


def _load_address(explicit: str = "") -> str:
    if explicit:
        return explicit
    env = os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if env:
        return env
    if os.path.exists(_addr_file()):
        return open(_addr_file()).read().strip()
    raise SystemExit("no running cluster found; pass --address or run "
                     "`python -m ray_tpu_torch start --head` first")


def _connect(address: str):
    import ray_tpu_torch

    ray_tpu_torch.init(address=address, ignore_reinit_error=True)
    return ray_tpu_torch


def cmd_start(args):
    from ray_tpu_torch._private.node import (
        _AGENT_BOOTSTRAP, _HEAD_BOOTSTRAP, detect_node_resources,
        new_session_dir, worker_sys_path)

    resources = json.loads(args.resources) if args.resources else None
    res = detect_node_resources(args.num_cpus, args.num_gpus, resources)
    env = {**os.environ, "RAY_TPU_TORCH_SYS_PATH": worker_sys_path()}
    if args.head:
        session_dir = new_session_dir()
        cmd = [sys.executable, "-S", "-c", _HEAD_BOOTSTRAP,
               "--session-dir", session_dir,
               "--resources", json.dumps(res),
               "--num-initial-workers", str(args.num_initial_workers),
               "--port", str(args.port)]
        if args.host:
            cmd += ["--host", args.host]
        proc = subprocess.Popen(
            cmd, env=env, start_new_session=True,
            stdout=open(os.path.join(session_dir, "gcs.out"), "ab"),
            stderr=subprocess.STDOUT)
        ready = os.path.join(session_dir, "gcs.ready")
        deadline = time.time() + 30
        while not os.path.exists(ready):
            if proc.poll() is not None:
                out = open(os.path.join(session_dir, "gcs.out")).read()
                raise SystemExit(f"head failed to start:\n{out}")
            if time.time() > deadline:
                raise SystemExit("timed out waiting for head")
            time.sleep(0.05)
        address = open(ready).read().strip()
        _save_address(address)
        print(f"ray_tpu_torch head started (pid {proc.pid}).")
        print(f"  address: {address}")
        print(f"  session: {session_dir}")
        print("Connect with ray_tpu_torch.init("
              f"address={address!r}) or join hosts with:\n"
              f"  python -m ray_tpu_torch start --address {address}")
    else:
        address = _load_address(args.address)
        session_dir = new_session_dir()
        cmd = [sys.executable, "-S", "-c", _AGENT_BOOTSTRAP,
               "--gcs", address,
               "--session-dir", session_dir,
               "--resources", json.dumps(res),
               "--num-initial-workers", str(args.num_initial_workers)]
        proc = subprocess.Popen(
            cmd, env=env, start_new_session=True,
            stdout=open(os.path.join(session_dir, "agent.out"), "ab"),
            stderr=subprocess.STDOUT)
        print(f"ray_tpu_torch node agent started (pid {proc.pid}), "
              f"joined {address}")


def cmd_stop(args):
    address = _load_address(args.address)
    try:
        rt = _connect(address)
        rt._worker_mod.global_worker().request_gcs({"t": "shutdown"},
                                                   timeout=5)
        print("cluster stopped")
    except Exception as e:  # noqa: BLE001
        print(f"could not reach cluster at {address}: {e}")
    try:
        os.unlink(_addr_file())
    except OSError:
        pass


def cmd_status(args):
    rt = _connect(_load_address(args.address))
    total = rt.cluster_resources()
    avail = rt.available_resources()
    nodes = rt.nodes()
    print(f"======== Cluster status ({len(nodes)} nodes) ========")
    print("Resources")
    for k in sorted(total):
        used = total[k] - avail.get(k, 0.0)
        if k == "memory" or k == "object_store_memory":
            print(f"  {used / 1e9:.1f}GiB/{total[k] / 1e9:.1f}GiB {k}")
        else:
            print(f"  {used:g}/{total[k]:g} {k}")
    print("Nodes")
    for n in nodes:
        state = "ALIVE" if n["Alive"] else "DEAD"
        print(f"  {n['NodeID'][:12]} {state:6} {n['NodeManagerHostname']} "
              f"workers={n['Workers']}")


def cmd_list(args):
    from ray_tpu_torch.util import state

    _connect(_load_address(args.address))
    fn = {
        "nodes": state.list_nodes, "workers": state.list_workers,
        "actors": state.list_actors, "tasks": state.list_tasks,
        "objects": state.list_objects,
        "placement-groups": state.list_placement_groups,
    }[args.kind]
    items = fn(limit=args.limit)
    if args.format == "json":
        print(json.dumps(items, indent=2, default=str))
        return
    if not items:
        print(f"no {args.kind}")
        return
    cols = list(items[0].keys())
    widths = {c: max(len(c), *(len(str(i.get(c, ""))[:40]) for i in items))
              for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for i in items:
        print("  ".join(str(i.get(c, ""))[:40].ljust(widths[c])
                        for c in cols))


def cmd_summary(args):
    from ray_tpu_torch.util import state

    _connect(_load_address(args.address))
    summary = state.summarize_tasks()
    for name, states in sorted(summary.items()):
        desc = ", ".join(f"{k}={v}" for k, v in sorted(states.items()))
        print(f"{name}: {desc}")


def cmd_timeline(args):
    from ray_tpu_torch.util import state

    _connect(_load_address(args.address))
    events = state.timeline(args.output, planes=args.planes)
    lanes = {e["pid"] for e in events if "plane:" in str(e.get("pid"))}
    extra = f" ({len(lanes)} plane lanes)" if args.planes else ""
    print(f"wrote {len(events)} events to {args.output}{extra}")


def cmd_metrics(args):
    from ray_tpu_torch.util import state

    _connect(_load_address(args.address))
    sys.stdout.write(state.prometheus_metrics())


def cmd_job(args):
    from ray_tpu_torch.job import JobSubmissionClient

    client = JobSubmissionClient(_load_address(args.address))
    if args.job_cmd == "submit":
        import shlex

        words = args.entrypoint
        if words and words[0] == "--":
            words = words[1:]
        job_id = client.submit_job(entrypoint=shlex.join(words),
                                   runtime_env=json.loads(args.runtime_env)
                                   if args.runtime_env else None)
        print(f"submitted job {job_id}")
        if not args.no_wait:
            status = client.wait_until_finish(job_id)
            print(f"job {job_id} finished: {status}")
            sys.stdout.write(client.get_job_logs(job_id))
    elif args.job_cmd == "status":
        print(client.get_job_status(args.job_id))
    elif args.job_cmd == "logs":
        sys.stdout.write(client.get_job_logs(args.job_id))
    elif args.job_cmd == "stop":
        client.stop_job(args.job_id)
        print(f"stopped job {args.job_id}")
    elif args.job_cmd == "list":
        for j in client.list_jobs():
            print(f"{j['job_id']}  {j['status']:10}  {j['entrypoint'][:60]}")


def cmd_serve(args):
    """Serve CLI (reference: ``python/ray/serve/scripts.py``)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve

    # the running cluster's, as every other command (the reference's
    # init(address=None) started a cluster of its own for the command)
    ray_tpu_torch.init(address=_load_address(args.address),
                       ignore_reinit_error=True)
    if args.serve_cmd == "deploy":
        from ray_tpu_torch.serve.config_file import deploy_config

        names = deploy_config(args.config)
        print(f"deployed {len(names)} app(s): {', '.join(names)}")
        print(f"HTTP ingress: port {serve.get_proxy_port()}, "
              f"RPC ingress: port {serve.get_rpc_port()}")
    elif args.serve_cmd == "status":
        for app, deps in serve.status().items():
            for name, d in deps.items():
                print(f"{app}/{name}: {d['num_replicas']} replica(s)")
    elif args.serve_cmd == "shutdown":
        serve.shutdown()
        print("serve shut down")


def cmd_check(args):
    """Static analysis for distributed anti-patterns (reference's
    ``analysis/``)."""
    from ray_tpu_torch._private.roadmap import not_ported

    raise not_ported("check (static checks, analysis/)", "tooling")


def cmd_up(args):
    """Cluster launcher (reference: ``ray up``, ``autoscaler/_private/
    commands.py create_or_update_cluster``)."""
    from ray_tpu_torch.autoscaler import launcher

    out = launcher.up(args.config, no_start=args.no_start)
    print(f"head {out['head_instance']} at {out['head_ip']} "
          f"({out['num_hosts']} host(s))")


def cmd_down(args):
    from ray_tpu_torch.autoscaler import launcher

    killed = launcher.down(args.config)
    print(f"terminated {len(killed)} instance(s): {', '.join(killed)}"
          if killed else "nothing to terminate")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head node or join a cluster")
    p.add_argument("--head", action="store_true")
    p.add_argument("--port", type=int, default=6380)
    p.add_argument("--host", default="")
    p.add_argument("--address", default="")
    p.add_argument("--num-cpus", type=int)
    p.add_argument("--num-gpus", type=int)
    p.add_argument("--resources", default="")
    p.add_argument("--num-initial-workers", type=int, default=2)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop the cluster")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("serve", help="model serving (deploy/status/shutdown)")
    ssub = p.add_subparsers(dest="serve_cmd", required=True)
    sp = ssub.add_parser("deploy", help="deploy apps from a config YAML")
    sp.add_argument("config")
    sp.add_argument("--address", default="")
    sp = ssub.add_parser("status")
    sp.add_argument("--address", default="")
    sp = ssub.add_parser("shutdown")
    sp.add_argument("--address", default="")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("check", help="static analysis for distributed "
                       "anti-patterns (not in ray_tpu_torch yet)")
    p.add_argument("paths", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("up", help="launch a cloud GPU cluster from YAML")
    p.add_argument("config", help="cluster YAML (see autoscaler/launcher.py)")
    p.add_argument("--no-start", action="store_true",
                   help="provision + setup only, don't start the runtime")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="tear down a cloud GPU cluster")
    p.add_argument("config")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("status", help="cluster resource summary")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list", help="list cluster state")
    p.add_argument("kind", choices=["nodes", "workers", "actors", "tasks",
                                    "objects", "placement-groups"])
    p.add_argument("--address", default="")
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--format", choices=["table", "json"], default="table")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("summary", help="task summary by function name")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("timeline", help="export Chrome trace of task events")
    p.add_argument("--address", default="")
    p.add_argument("-o", "--output", default="ray_tpu_timeline.json")
    p.add_argument("--planes", action="store_true",
                   help="merge the plane-event flight recorder into the "
                        "trace: one lane per (node, plane) — broadcast/"
                        "collective/serve/lease/wait/admission events on "
                        "the same clock as the task plane")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("metrics", help="dump Prometheus metrics")
    p.add_argument("--address", default="")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("job", help="job submission")
    jsub = p.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--address", default="")
    j.add_argument("--runtime-env", default="")
    j.add_argument("--no-wait", action="store_true")
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("job_id")
        j.add_argument("--address", default="")
    j = jsub.add_parser("list")
    j.add_argument("--address", default="")
    p.set_defaults(fn=cmd_job)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
