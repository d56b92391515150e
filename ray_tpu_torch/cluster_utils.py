"""In-process multi-node cluster simulation for tests.

Analog of the reference's ``ray.cluster_utils.Cluster``
(``python/ray/cluster_utils.py:135``): extra "nodes" are extra node-agent
processes on this machine, each with its own node id and resource set,
registering with the shared GCS. Lets every multi-node code path (spread
scheduling, STRICT_SPREAD placement groups, node failure handling) run on
one host (each simulated node a host with its own CPUs and GPUs).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ._private.node import HeadNode, detect_node_resources


class _ForkedProc:
    """Popen-shaped handle for an agent forked from the agent zygote.

    The child is the ZYGOTE's child and is auto-reaped there (SIG_IGN),
    so a bare ``os.kill(pid, 0)`` liveness probe would be fooled by pid
    reuse — and ``NodeHandle.kill``'s killpg could then hit an unrelated
    process group. Liveness therefore verifies identity through /proc:
    the pid must still be our zygote's child (or, if the zygote died
    first and the agent was reparented, its cmdline must still be the
    zygote bootstrap — agents keep it across fork)."""

    def __init__(self, pid: int, zygote_pid: int):
        self.pid = pid
        self._zygote_pid = zygote_pid

    def _is_ours(self) -> bool:
        try:
            with open(f"/proc/{self.pid}/stat", "rb") as f:
                ppid = int(f.read().rsplit(b") ", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            return False
        if ppid == self._zygote_pid:
            return True
        try:
            with open(f"/proc/{self.pid}/cmdline", "rb") as f:
                return b"agent_main_from_req" in f.read()
        except OSError:
            return False

    def poll(self):
        return None if self._is_ours() else -1

    def wait(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.time() + timeout
        while self.poll() is None:
            if deadline is not None and time.time() > deadline:
                raise subprocess.TimeoutExpired("forked-agent", timeout)
            time.sleep(0.02)
        return -1


class NodeHandle:
    def __init__(self, proc, node_id_hex: str,
                 resources: Dict[str, float]):
        self.proc = proc
        self.node_id = node_id_hex
        self.resources = resources

    def kill(self, sig=signal.SIGKILL):
        """Kill the whole node process group (agent + its workers)."""
        if isinstance(self.proc, _ForkedProc) and self.proc.poll() is not None:
            return  # dead (or the pid was reused — never signal a stranger)
        try:
            os.killpg(self.proc.pid, sig)
        except ProcessLookupError:
            pass


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 connect: bool = False,
                 head_node_args: Optional[dict] = None):
        self.head: Optional[HeadNode] = None
        self.worker_nodes: List[NodeHandle] = []
        self.address: Optional[str] = None
        if initialize_head:
            args = dict(head_node_args or {})
            args.setdefault("probe_gpu", False)
            self.head = HeadNode(**args)
            self.address = self.head.address
        if connect:
            self.connect()

    def connect(self):
        import ray_tpu_torch

        ray_tpu_torch.init(address=self.address, ignore_reinit_error=True)

    def _ensure_agent_zygote(self):
        """Start (once) the pre-imported agent template; forking agents
        from it costs ~10ms each instead of ~350ms of interpreter+import
        CPU — the difference between 2.9 and >40 node joins/s on one core
        (reference envelope: release/.../many_nodes.json)."""
        z = getattr(self, "_agent_zygote", None)
        if z is not None and z.poll() is None:
            return z
        from ._private.node import _AGENT_ZYGOTE_BOOTSTRAP, worker_sys_path

        env = {**os.environ, "RAY_TPU_TORCH_SYS_PATH": worker_sys_path()}
        env.pop("RAY_TPU_TORCH_NODE_ID", None)
        z = subprocess.Popen(
            [sys.executable, "-S", "-c", _AGENT_ZYGOTE_BOOTSTRAP],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=open(os.path.join(self.head.session_dir,
                                     "agent-zygote.err"), "ab"),
            start_new_session=True, env=env, text=True, bufsize=1)
        ready = self._zygote_readline(z, timeout=60)
        if "READY" not in ready:
            raise RuntimeError(
                f"agent zygote failed to start: {ready!r} "
                f"(see {self.head.session_dir}/agent-zygote.err)")
        self._agent_zygote = z
        return z

    def _zygote_readline(self, z, timeout: float) -> str:
        """One reply line from the zygote, with a deadline — a wedged or
        dead zygote must surface as an error, not a hang (its stderr goes
        to agent-zygote.err in the session dir)."""
        import select

        deadline = time.time() + timeout
        while True:
            remaining = deadline - time.time()
            # Drain-before-raise: a reply written just before the zygote
            # died must still be consumed (the forked agent it names is
            # alive and must be tracked).
            r, _, _ = select.select([z.stdout], [], [],
                                    max(0.0, min(remaining, 1.0)))
            if r:
                line = z.stdout.readline()
                if line:
                    return line
                raise RuntimeError(
                    "agent zygote died (EOF) — see "
                    f"{self.head.session_dir}/agent-zygote.err")
            if z.poll() is not None:
                raise RuntimeError(
                    "agent zygote died — see "
                    f"{self.head.session_dir}/agent-zygote.err")
            if remaining <= 0:
                raise RuntimeError(
                    "agent zygote timed out — see "
                    f"{self.head.session_dir}/agent-zygote.err")

    def add_node(self, num_cpus: int = 1, num_gpus: int = 0,
                 resources: Optional[Dict[str, float]] = None,
                 num_initial_workers: int = 1,
                 env: Optional[Dict[str, str]] = None,
                 isolate_store: bool = True,
                 use_zygote: bool = True) -> NodeHandle:
        assert self.address is not None, "cluster has no head"
        from ._private.ids import NodeID

        node_id = NodeID.from_random()
        res = detect_node_resources(num_cpus=num_cpus, num_gpus=num_gpus,
                                    resources=resources)
        from ._private.node import _AGENT_BOOTSTRAP, worker_sys_path

        child_env = {**os.environ, "RAY_TPU_TORCH_NODE_ID": node_id.hex(),
                     "RAY_TPU_TORCH_SYS_PATH": worker_sys_path()}
        if isolate_store:
            # One arena per simulated node: cross-node object movement
            # exercises the REAL p2p transfer path (on real multi-host
            # clusters isolation comes from the hosts themselves).
            child_env["RAY_TPU_TORCH_STORE_SUFFIX"] = f"-n{node_id.hex()[:8]}"
        log_path = os.path.join(self.head.session_dir,
                                f"agent-{node_id.hex()[:8]}.out")
        if use_zygote:
            # Fork from the pre-imported template: the child replaces its
            # environment wholesale from the request (and rebuilds the
            # lazily-cached flag table), so env semantics match Popen.
            z = self._ensure_agent_zygote()
            z.stdin.write(json.dumps({
                "gcs": self.address, "session_dir": self.head.session_dir,
                "resources": json.dumps(res),
                "num_initial_workers": num_initial_workers,
                "task_env": json.dumps(env or {}),
                "env": child_env, "log": log_path}) + "\n")
            z.stdin.flush()
            reply = self._zygote_readline(z, timeout=60).strip()
            if not reply or reply.startswith("ERR"):
                raise RuntimeError(
                    f"agent zygote could not fork a node: {reply or 'EOF'}")
            proc = _ForkedProc(int(reply), z.pid)
        else:
            proc = subprocess.Popen(
                [sys.executable, "-S", "-c", _AGENT_BOOTSTRAP,
                 "--gcs", self.address,
                 "--session-dir", self.head.session_dir,
                 "--resources", json.dumps(res),
                 "--num-initial-workers", str(num_initial_workers),
                 "--env", json.dumps(env or {})],
                start_new_session=True,
                stdout=open(log_path, "ab"),
                stderr=subprocess.STDOUT,
                env=child_env,
            )
        handle = NodeHandle(proc, node_id.hex(), res)
        self.worker_nodes.append(handle)
        return handle

    def remove_node(self, node: NodeHandle, allow_graceful: bool = True):
        node.kill(signal.SIGTERM if allow_graceful else signal.SIGKILL)
        try:
            node.proc.wait(5)
        except subprocess.TimeoutExpired:
            node.kill(signal.SIGKILL)
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)

    def wait_for_nodes(self, count: Optional[int] = None,
                       timeout: float = 30) -> bool:
        """Wait until `count` nodes (default: all added) are registered."""
        import ray_tpu_torch

        expect = count if count is not None else 1 + len(self.worker_nodes)
        deadline = time.time() + timeout
        while time.time() < deadline:
            alive = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
            if len(alive) >= expect:
                return True
            time.sleep(0.05)
        return False

    def wait_for_workers(self, min_per_node: int = 1,
                         timeout: float = 60) -> bool:
        """Wait until every alive node has registered worker processes."""
        import ray_tpu_torch
        from ray_tpu_torch._private.worker import global_worker

        deadline = time.time() + timeout
        while time.time() < deadline:
            info = global_worker().cluster_info()
            nodes = [n for n in info["nodes"] if n["alive"]]
            if nodes and all(n["workers"] >= min_per_node for n in nodes):
                return True
            time.sleep(0.1)
        return False

    def shutdown(self):
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            ray_tpu_torch.shutdown()
        for node in list(self.worker_nodes):
            self.remove_node(node, allow_graceful=False)
        z = getattr(self, "_agent_zygote", None)
        if z is not None:
            try:
                if z.poll() is None:
                    z.stdin.close()
                    z.terminate()
                z.wait(5)  # reap — no zombie between Cluster lifecycles
            except (OSError, subprocess.TimeoutExpired):
                try:
                    z.kill()
                    z.wait(2)
                except (OSError, subprocess.TimeoutExpired):
                    pass
            self._agent_zygote = None
        if self.head is not None:
            self.head.stop()
            self.head = None
