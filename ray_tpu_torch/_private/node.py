"""Node lifecycle: session directories, the head process, and node agents.

Analog of the reference's ``Node`` process supervisor
(``python/ray/_private/node.py:37``) and the raylet's worker pool + agent
manager (``raylet/worker_pool.h:174``, ``raylet/agent_manager.h:45``). A
"node" here is a TPU host: the agent registers the host's resources
(CPU / memory / TPU chips and slice topology) with the GCS and spawns worker
processes on demand.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional

from . import failpoints, protocol
from .ids import NodeID

from .config import config as _cfg

DEFAULT_STORE_CAPACITY = _cfg().store_capacity

# Rows per obj_report frame (agent arena resync). Own constant: sizing
# these frames with a reference-plane knob (obj_waits_max_batch) would
# couple two unrelated tuning surfaces.
_OBJ_REPORT_BATCH = 4096


def default_session_root() -> str:
    return os.environ.get("RAY_TPU_TORCH_TMPDIR", "/tmp/ray_tpu_torch")


def get_node_ip_address() -> str:
    """The loopback address: the port's clusters are one host (joining
    other hosts comes with the autoscaler, ROADMAP A13), so it never asks
    for a route or a name outside it, as the reference's
    ``services.get_node_ip_address`` does."""
    return "127.0.0.1"


def new_session_dir() -> str:
    root = default_session_root()
    name = f"session_{time.strftime('%Y%m%d_%H%M%S')}_{uuid.uuid4().hex[:8]}"
    path = os.path.join(root, name)
    os.makedirs(path, exist_ok=True)
    latest = os.path.join(root, "session_latest")
    try:
        if os.path.islink(latest):
            os.unlink(latest)
        os.symlink(path, latest)
    except OSError:
        pass
    return path


def detect_node_resources(num_cpus: Optional[int] = None,
                          num_gpus: Optional[int] = None,
                          resources: Optional[Dict[str, float]] = None
                          ) -> Dict[str, float]:
    """Detect this host's schedulable resources.

    The GPU count is ``num_gpus`` when given, else ``RAY_TPU_TORCH_GPUS``,
    else left to the agent's asynchronous probe (``_GPU_PROBE``, run in a
    subprocess so no runtime process ever holds a CUDA context).
    """
    out: Dict[str, float] = {}
    out["CPU"] = float(num_cpus if num_cpus is not None
                       else max(os.cpu_count() or 1, 1))
    mem = 0
    try:
        import psutil

        mem = psutil.virtual_memory().available
    except Exception:
        pass
    out["memory"] = float(mem or 1 << 30)
    out["object_store_memory"] = float(DEFAULT_STORE_CAPACITY)
    if num_gpus is not None:
        gpus = float(num_gpus)
    else:
        gpus = float(os.environ.get("RAY_TPU_TORCH_GPUS") or 0)
        # else: async probe later (agent sends update_resources)
    if gpus > 0:
        out["GPU"] = gpus
    if resources:
        out.update(resources)
    return out


_GPU_PROBE = """
try:
    import torch
    print(torch.cuda.device_count())
except Exception:
    print(0)
"""

_WORKER_BOOTSTRAP = (
    "import sys, os\n"
    "sys.path[:0] = os.environ['RAY_TPU_TORCH_SYS_PATH'].split(os.pathsep)\n"
    "from ray_tpu_torch._private.worker_main import main\n"
    "main()\n"
)

# Head/agent processes bootstrap the same way: ``-S`` skips slow site
# processing AND the inherited path covers drivers that import ray_tpu_torch from
# a source checkout rather than an installed package.
_HEAD_BOOTSTRAP = (
    "import sys, os\n"
    "sys.path[:0] = os.environ['RAY_TPU_TORCH_SYS_PATH'].split(os.pathsep)\n"
    "from ray_tpu_torch._private.node import head_main\n"
    "head_main()\n"
)

# Zygote worker template (reference: worker_pool.h prestarted workers,
# taken further): ONE process pays the interpreter+import cost, then
# forks ~10ms children on demand — the actor/worker launch floor drops
# ~20x. Request protocol: one JSON line per spawn on stdin, child pid
# replied on stdout; requests PIPELINE (the agent writes a whole burst,
# then collects the pids), so a 200-actor launch storm isn't serialized
# on one handshake round-trip per fork. Fork safety: the template runs no
# event loop and no threads; SIGCHLD=SIG_IGN auto-reaps exited children
# (children restore SIG_DFL before entering worker main so user
# subprocesses still wait()); children setsid, redirect stdio to their
# log, and enter the normal worker main.
_ZYGOTE_BOOTSTRAP = """
import json, os, signal, sys
sys.path[:0] = os.environ['RAY_TPU_TORCH_SYS_PATH'].split(os.pathsep)
import ray_tpu_torch._private.worker_main as wm
import ray_tpu_torch._private.node         # noqa: F401 (pre-import for forks)
# numpy and torch ride nearly every arg/result bundle (zero-copy array and
# tensor views); importing them lazily at a forked worker's FIRST
# deserialize costs seconds of single-core time per worker — pay it once
# in the template. The template never touches CUDA: a child forked from a
# process with a CUDA context cannot use the card.
import numpy                          # noqa: F401
import torch
signal.signal(signal.SIGCHLD, signal.SIG_IGN)
sys.stdout.write("READY\\n"); sys.stdout.flush()
for line in sys.stdin:
    if not line.strip():
        continue
    req = json.loads(line)
    if torch.cuda.is_initialized():
        raise RuntimeError("worker template initialised CUDA; cannot fork")
    pid = os.fork()
    if pid == 0:
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        os.setsid()
        for k, v in req.get("env", {}).items():
            os.environ[k] = v
        for k in req.get("unset", []):
            os.environ.pop(k, None)
        log = open(req["log"], "ab", 0)
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
        wm.main_from_req(req)
        os._exit(0)
    sys.stdout.write(str(pid) + "\\n"); sys.stdout.flush()
"""

_AGENT_BOOTSTRAP = (
    "import sys, os\n"
    "sys.path[:0] = os.environ['RAY_TPU_TORCH_SYS_PATH'].split(os.pathsep)\n"
    "from ray_tpu_torch._private.node import agent_main\n"
    "agent_main()\n"
)

# Agent zygote: fork node agents from one pre-imported template instead of
# cold-starting an interpreter + import tree per node (~350ms of single-core
# CPU each — the 2.9 joins/s ceiling a many-nodes bench hit).
# Same shape as the worker zygote above; cluster_utils drives it for
# many-node simulations and the autoscaler's local provider.
_AGENT_ZYGOTE_BOOTSTRAP = """
import json, os, signal, sys
sys.path[:0] = os.environ['RAY_TPU_TORCH_SYS_PATH'].split(os.pathsep)
from ray_tpu_torch._private.node import agent_main_from_req
signal.signal(signal.SIGCHLD, signal.SIG_IGN)
sys.stdout.write("READY\\n"); sys.stdout.flush()
for line in sys.stdin:
    if not line.strip():
        continue
    try:
        req = json.loads(line)
        pid = os.fork()
    except Exception as e:  # fork EAGAIN/ENOMEM must reach the caller
        sys.stdout.write("ERR " + repr(e) + "\\n"); sys.stdout.flush()
        continue
    if pid == 0:
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        # Own process group IMMEDIATELY (both sides race-free setpgid —
        # setsid would fail once the parent's setpgid lands, and killpg
        # from the driver must never hit the zygote's group).
        try:
            os.setpgid(0, 0)
        except OSError:
            pass
        os.environ.clear()
        os.environ.update(req["env"])
        log = open(req["log"], "ab", 0)
        os.dup2(log.fileno(), 1)
        os.dup2(log.fileno(), 2)
        agent_main_from_req(req)
        os._exit(0)
    try:
        os.setpgid(pid, pid)
    except OSError:
        pass
    sys.stdout.write(str(pid) + "\\n"); sys.stdout.flush()
"""


def agent_main_from_req(req: dict):
    """Agent-zygote fork entry: args ride the fork request; the child's
    environment was replaced wholesale, so the lazily-cached flag table
    must be rebuilt from the new env before anything reads it."""
    import types

    from .config import reset_config

    reset_config()
    args = types.SimpleNamespace(
        gcs=req["gcs"], session_dir=req["session_dir"],
        resources=req["resources"],
        num_initial_workers=req.get("num_initial_workers", 1),
        env=req.get("task_env", "{}"))
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    _run_with_optional_profile(lambda: agent_amain(args), "agent")


def worker_sys_path() -> str:
    """The parent's import path, for ``python -S`` worker bootstrap."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    paths = [pkg_root] + [p for p in sys.path if p]
    seen, out = set(), []
    for p in paths:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return os.pathsep.join(out)


# ---------------------------------------------------------------- drain
# Preemption-notice sources (the pluggable half of the graceful-drain
# subsystem): real TPU fleets get ADVANCE notice before a slice is
# reclaimed (GCE preemption/maintenance signals); the agent polls a
# source and self-reports a drain request to the GCS so work migrates
# BEFORE the hardware disappears. Select with the
# ``preemption_notice_source`` flag: "file" (default; also the fake
# source chaos tests drive), "gce", or "none".


class FilePreemptionSource:
    """Notice = the watched file exists. Contents may be empty (defaults
    apply) or JSON ``{"reason": ..., "deadline_s": ...}`` / plain text
    (used as the reason)."""

    def __init__(self, path: str):
        self.path = path

    def poll(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                raw = f.read().strip()
        except OSError:
            return None
        notice = {"reason": f"preemption notice ({self.path})",
                  "deadline_s": None}
        if raw:
            try:
                data = json.loads(raw)
            except ValueError:
                data = raw
            if isinstance(data, dict):
                notice.update({k: data[k] for k in ("reason", "deadline_s")
                               if k in data})
            else:
                notice["reason"] = str(data)
        return notice


def make_preemption_source(node_id: NodeID, session_dir: str):
    """Build this node's notice source from config (None = disabled)."""
    kind = _cfg().preemption_notice_source
    if kind == "none":
        return None
    if kind == "gce":
        # a cloud metadata server is an outside host; the drain plane's
        # sources beyond the file come with the autoscaler
        from .roadmap import not_ported

        raise not_ported("the gce preemption source", "tooling")
    path = _cfg().preemption_notice_file or os.path.join(
        session_dir, f"preempt-{node_id.hex()}")
    return FilePreemptionSource(path)


class NodeAgent:
    """Per-node agent: registers the node, spawns/reaps workers."""

    def __init__(self, gcs_address: str, session_dir: str,
                 resources: Dict[str, float],
                 node_id: Optional[NodeID] = None,
                 num_initial_workers: int = 2,
                 env_overrides: Optional[Dict[str, str]] = None,
                 probe_gpu: bool = False):
        self.gcs_address = gcs_address
        self.session_dir = session_dir
        self.node_id = node_id or NodeID.from_random()
        self.resources = resources
        self.num_initial_workers = num_initial_workers
        self.env_overrides = env_overrides or {}
        self.probe_gpu = probe_gpu
        self.conn: Optional[protocol.Connection] = None
        self.procs: List[subprocess.Popen] = []
        self.stopped = asyncio.Event()
        self._obj_serve_sock = None
        self.obj_addr: Optional[str] = None
        self._store = None
        self._store_lock = threading.Lock()
        self._zygote: Optional[subprocess.Popen] = None
        self._zygote_rbuf = b""   # raw pid-line read buffer (spawner thread)
        self._spawn_q = None      # queue.SimpleQueue, created lazily
        self._spawner = None      # spawner thread owning the zygote pipe
        self.zygote_pids: set = set()

    async def start(self):
        self._loop = asyncio.get_running_loop()
        await self._start_obj_server()
        await self._connect_and_register()
        for _ in range(self.num_initial_workers):
            self.spawn_worker()
        if self.probe_gpu and "GPU" not in self.resources:
            asyncio.get_running_loop().create_task(self._probe_gpu())
        asyncio.get_running_loop().create_task(self._reap_loop())
        if _cfg().memory_monitor_threshold > 0:
            asyncio.get_running_loop().create_task(
                self._memory_monitor_loop())
        self._preempt_source = make_preemption_source(self.node_id,
                                                      self.session_dir)
        if self._preempt_source is not None:
            asyncio.get_running_loop().create_task(
                self._preemption_watch_loop())

    async def _preemption_watch_loop(self):
        """Poll the preemption-notice source; on notice, self-report a
        drain request to the GCS (the node agent half of the graceful
        drain protocol — the control plane stops placements, migrates
        restartable actors, and forces DEAD at the deadline)."""
        interval = _cfg().preemption_poll_interval_s
        notified = False
        while not self.stopped.is_set():
            await asyncio.sleep(interval)
            try:
                # Executor thread: sources may block (GCE metadata HTTP /
                # DNS) and must not stall the agent loop — a wedged loop
                # misses GCS health checks and gets the node declared
                # dead.
                notice = await asyncio.get_running_loop().run_in_executor(
                    None, self._preempt_source.poll)
            except Exception:  # noqa: BLE001 — a broken source never
                continue       # takes the agent down
            if notice is None:
                continue
            if self.conn is None or self.conn.closed:
                continue  # retry after reconnect: the notice must land
            raw = notice.get("deadline_s")
            deadline_s = (float(raw) if raw is not None
                          else _cfg().drain_deadline_s)
            try:
                self.conn.send({
                    "t": "drain_node", "node_id": self.node_id.binary(),
                    "reason": notice.get("reason", "preemption notice"),
                    "deadline_s": deadline_s})
            except ConnectionError:
                continue
            if not notified:
                import logging

                logging.getLogger(__name__).warning(
                    "preemption notice on node %s: %s (drain deadline "
                    "%.1fs)", self.node_id.hex()[:8], notice.get("reason"),
                    deadline_s)
            notified = True
            # Keep polling and RE-SENDING (idempotent on the GCS — the
            # earliest deadline wins): a fire-and-forget notice sent just
            # before a GCS crash/restart would otherwise be lost forever,
            # with the node silently accepting placements until the
            # hardware vanishes.

    async def _memory_monitor_loop(self):
        """Host-memory OOM protection (reference: ``memory_monitor.h:52``
        + retriable-FIFO worker killing): above the threshold, SIGKILL the
        newest retriable task worker so the retry path absorbs the kill;
        report the reason to the GCS as an ``oom_kill`` node event."""
        from .memory_monitor import (host_memory_usage_fraction,
                                     pick_victim, proc_rss_bytes)

        threshold = _cfg().memory_monitor_threshold
        interval = _cfg().memory_monitor_interval_s
        recently_killed: dict = {}  # pid -> kill ts (cooldown tracking)
        cooldown = max(2.0 * interval, 2.0)
        while not self.stopped.is_set():
            await asyncio.sleep(interval)
            usage = host_memory_usage_fraction()
            if usage < threshold:
                continue
            now = time.time()
            # Exclusion lasts one cooldown window, not forever: a recycled
            # pid must become a candidate again once its kill has settled.
            recently_killed = {p: t for p, t in recently_killed.items()
                               if now - t < cooldown}
            if any(now - ts < cooldown for ts in recently_killed.values()):
                # A kill is still settling (teardown + GCS catching up):
                # don't cascade onto healthy workers.
                continue
            if self.conn is None or self.conn.closed:
                continue
            try:
                reply = await self.conn.request(
                    {"t": "oom_candidates",
                     "node_id": self.node_id.binary()}, timeout=10)
            except (ConnectionError, asyncio.TimeoutError):
                continue
            # Only OUR direct children are killable: container-pool
            # workers report namespace-local pids (killing that number on
            # the host would hit an unrelated process), and GCS lag can
            # list already-dead workers.
            own_pids = {p.pid for p in self.procs if p.poll() is None}
            # Fork children are killable too — but verified LIVE against
            # the zygote's parent link, never via the historical pid set
            # (recycled pids would hit unrelated processes).
            own_pids |= {p for p in self.zygote_pids
                         if self._is_zygote_child(p)}
            candidates = [tuple(c) for c in reply.get("candidates", [])
                          if c[0] in own_pids
                          and c[0] not in recently_killed]
            victim = pick_victim(candidates)
            if victim is None:
                continue
            rss = proc_rss_bytes(victim)
            try:
                os.kill(victim, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                continue
            recently_killed[victim] = time.time()
            try:
                self.conn.send({"t": "oom_kill_report", "pid": victim,
                                "usage": usage, "rss": rss})
            except ConnectionError:
                pass

    async def _connect_and_register(self):
        reader, writer = await protocol.connect(self.gcs_address)
        self.conn = protocol.Connection(
            reader, writer, handler=self._on_msg,
            on_close=self._on_gcs_close)
        self.conn.start()
        await self.conn.request({
            "t": "hello", "role": "agent",
            "node_id": self.node_id.binary(),
            "resources": self.resources,
            "hostname": os.uname().nodename,
            "obj_addr": self.obj_addr,
            "store_suffix": os.environ.get("RAY_TPU_TORCH_STORE_SUFFIX", ""),
        }, timeout=30)
        self._report_arena_objects()

    def _report_arena_objects(self):
        """Re-report this host arena's sealed objects after (re)register:
        a restarted GCS rescans only the HEAD arena itself; other nodes'
        directories come back through this resync (reference: raylets
        resyncing object locations after GCS failover)."""
        try:
            store = self._host_store()
        except Exception:
            return
        if not hasattr(store, "list_objects"):
            return
        try:
            objs = store.list_objects()
        except Exception:
            return
        # Chunked frames: a big arena (tens of thousands of objects)
        # must not arrive as one giant frame — the GCS fair drain hands
        # every connection bounded slices, and one monolithic report
        # would both bloat the frame and stall its decode slot.
        rows = [[oid.binary(), n] for oid, n in objs]
        for i in range(0, len(rows), _OBJ_REPORT_BATCH):
            self.conn.send({"t": "obj_report",
                            "objs": rows[i:i + _OBJ_REPORT_BATCH]})

    # ------------------------------------------------ p2p object serving
    # The node-to-node half of the object plane (reference: object manager
    # chunked Push/Pull over dedicated gRPC, object_manager.h:117-206):
    # each agent serves reads from ITS host's shm arena over TCP; pullers
    # fetch chunks directly so bulk data never transits the head.

    async def _start_obj_server(self):
        # Loopback for same-host (UDS-attached) clusters; the node's
        # reachable IP when the cluster spans hosts (TCP GCS). Runs on
        # dedicated blocking-IO threads: bulk chunk serving must not
        # contend with the agent's control loop (or, on the head, the
        # whole GCS), and blocking sendall straight from the pinned arena
        # view skips the asyncio transport's buffering copy.
        from . import broadcast
        from .serialization import TRANSPORT_STATS

        host = ("127.0.0.1" if self.gcs_address.startswith("unix:")
                else get_node_ip_address())
        self.obj_addr, self._obj_serve_sock = broadcast.start_serve_thread(
            host, self._resolve_obj_fetch, name="agent-obj-serve",
            stats=TRANSPORT_STATS)

    def _host_store(self):
        if self._store is None:
            with self._store_lock:
                if self._store is None:
                    from .object_store import make_store

                    self._store = make_store(
                        os.path.basename(self.session_dir))
        return self._store

    def _resolve_obj_fetch(self, msg: dict):
        from .config import config
        from .ids import ObjectID
        from .object_store import open_spilled

        oid = ObjectID(bytes(msg["oid"]))
        try:
            view = self._host_store().get(oid, msg.get("nbytes", 0))
        except Exception:
            view = None
        if view is None and config().spill_serve:
            # Serve-from-spill: the arena copy was evicted but the GCS's
            # spill file sits at a deterministic session-dir path — pread
            # the requested chunk straight off it, no restore. A vanished
            # file resolves as a retryable miss, not a dead object.
            try:
                view = open_spilled(self.session_dir, oid,
                                    int(msg.get("nbytes", 0)))
            except Exception:
                view = None
            return view, view is None
        return view, False

    def _on_gcs_close(self):
        if not self.stopped.is_set():
            asyncio.get_running_loop().create_task(self._reconnect())

    async def _reconnect(self):
        """GCS connection lost: retry + re-register (GCS restart resync —
        reference: raylets resyncing after GCS failover,
        test_gcs_fault_tolerance.py). Gives up after ~15 s and stops the
        node, which matches losing the head permanently."""
        ok = await protocol.reconnect_with_retry(
            self._connect_and_register, should_stop=self.stopped.is_set)
        if not ok and not self.stopped.is_set():
            self.stopped.set()

    async def _probe_gpu(self):
        try:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-c", _GPU_PROBE,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.DEVNULL)
            out, _ = await asyncio.wait_for(proc.communicate(), timeout=120)
            n = int(out.strip() or 0)
        except Exception:
            n = 0
        if n > 0 and self.conn and not self.conn.closed:
            self.conn.send({"t": "update_resources",
                            "node_id": self.node_id.binary(),
                            "resources": {"GPU": float(n)}})

    def spawn_worker(self, env_spec: Optional[dict] = None,
                     env_key: str = ""):
        if failpoints.active():
            # Spawn boundary: ``drop`` loses the spawn request (the GCS's
            # spawning counter must decay via worker-hello timeout /
            # re-request, not wedge the lease plane); ``raise`` surfaces
            # as a spawn failure the env-failure ladder absorbs.
            if failpoints.fire("node.spawn_worker") == "drop":
                return
        if env_spec is not None:
            # Venv workers: the (possibly minutes-long, cached-thereafter)
            # environment build must not block the agent loop.
            import threading

            threading.Thread(target=self._spawn_env_worker,
                             args=(env_spec, env_key), daemon=True).start()
            return
        self._spawn(sys.executable, worker_sys_path(), "")

    def _spawn_env_worker(self, env_spec: dict, env_key: str):
        """Build (or reuse) the spec's venv — or wrap the spawn in a
        container — then launch the worker (reference: dedicated
        runtime-env workers launched by the runtime-env agent,
        ``runtime_env/pip.py`` / ``image_uri.py``)."""
        try:
            from .roadmap import not_ported

            raise not_ported("runtime_env " + str(env_spec.get("tool")),
                             "runtime_env")
        except Exception as e:  # noqa: BLE001
            # Runs on a builder thread: transport writes must be
            # marshalled onto the agent's event loop.
            err = str(e)
            self._loop.call_soon_threadsafe(self._send_spawn_failed, err,
                                            env_key)

    def _send_spawn_failed(self, err: str, env_key: str = ""):
        if self.conn is not None and not self.conn.closed:
            try:
                self.conn.send({"t": "spawn_failed",
                                "node_id": self.node_id.binary(),
                                "env_key": env_key,
                                "err": err})
            except ConnectionError:
                pass

    def _is_zygote_child(self, pid: int) -> bool:
        """Is this pid CURRENTLY a child of our zygote? Guards against
        pid recycling (zygote_pids is historical; the kernel's parent
        link is live truth)."""
        z = self._zygote
        if z is None or z.poll() is not None:
            return False
        try:
            with open(f"/proc/{pid}/status") as f:
                for line in f:
                    if line.startswith("PPid:"):
                        return int(line.split()[1]) == z.pid
        except (OSError, ValueError):
            pass
        return False

    def _zygote_available(self, python: str, wrap) -> bool:
        return (wrap is None and python == sys.executable
                and sys.platform.startswith("linux")
                and os.environ.get("RAY_TPU_TORCH_ZYGOTE", "1") != "0")

    def _pipe_read_line(self, timeout: float) -> str:
        """Read one line from the zygote's stdout with a deadline.

        Raw ``os.read`` + own buffer — a buffered file object would hide
        already-read lines from ``select`` and a healthy template could be
        declared wedged. Spawner thread only."""
        import select

        z = self._zygote
        fd = z.stdout.fileno()
        deadline = time.time() + timeout
        while b"\n" not in self._zygote_rbuf:
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError("zygote pipe read timed out")
            r, _, _ = select.select([fd], [], [], remaining)
            if not r:
                raise TimeoutError("zygote pipe read timed out")
            chunk = os.read(fd, 4096)
            if not chunk:
                raise OSError("zygote pipe EOF")
            self._zygote_rbuf += chunk
        line, self._zygote_rbuf = self._zygote_rbuf.split(b"\n", 1)
        return line.decode()

    def _ensure_zygote(self) -> Optional[subprocess.Popen]:
        """Start (or return) the zygote template. Runs ONLY on the spawner
        thread — the agent's event loop never touches the zygote pipe, so a
        stalled bootstrap can't wedge health-check replies (the GCS would
        declare the whole node dead)."""
        z = self._zygote
        if z is not None and z.poll() is None:
            return z
        env = dict(os.environ)
        env.update(self.env_overrides)
        env["RAY_TPU_TORCH_SYS_PATH"] = worker_sys_path()
        try:
            z = subprocess.Popen(
                [sys.executable, "-S", "-c", _ZYGOTE_BOOTSTRAP],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=open(os.path.join(self.session_dir,
                                         "zygote.out"), "ab"),
                env=env, bufsize=0)
            # The zygote handle is spawner-thread-owned: every loop-side
            # reader (_is_zygote_child, shutdown) derefs `self._zygote`
            # exactly once into a local and re-validates with poll(), so
            # these atomic rebinds can at worst hand it a just-retired
            # handle — which the poll() check rejects.
            self._zygote = z  # raylint: disable=RTL151 (atomic rebind; loop readers snapshot + poll()-validate)
            self._zygote_rbuf = b""
            ready = self._pipe_read_line(30.0)
            if ready.strip() != "READY":
                raise RuntimeError(f"zygote bootstrap said {ready!r}")
        except Exception:
            if z is not None and z.poll() is None:
                z.kill()
            self._zygote = None  # raylint: disable=RTL151 (atomic rebind; loop readers snapshot + poll()-validate)
            return None
        return z

    def _kill_zygote(self):
        z = self._zygote
        if z is not None and z.poll() is None:
            z.kill()
        self._zygote = None  # raylint: disable=RTL151 (atomic rebind; loop readers snapshot + poll()-validate)
        self._zygote_rbuf = b""

    def _spawn_batch_via_zygote(self, env_keys: List[str]) -> int:
        """Fork a burst of workers from the pre-imported template.

        Pipelined: all requests are written first, then the pids are
        collected — the per-fork handshake round-trip (tens of ms on a
        loaded host) is paid once per BURST, not once per worker. Returns
        how many spawns succeeded; the caller cold-spawns the rest.
        Spawner thread only."""
        z = self._ensure_zygote()
        if z is None:
            return 0
        lines = []
        for env_key in env_keys:
            req = {
                "env": {**self.env_overrides,
                        "RAY_TPU_TORCH_NODE_ID": self.node_id.hex()},
                "unset": [] if env_key else ["RAY_TPU_TORCH_ENV_KEY"],
                "gcs": self.gcs_address,
                "node_id": self.node_id.hex(),
                "session_dir": self.session_dir,
                "log": os.path.join(
                    self.session_dir,
                    f"worker-z{len(self.zygote_pids) + len(lines)}.out"),
            }
            if env_key:
                req["env"]["RAY_TPU_TORCH_ENV_KEY"] = env_key
            lines.append(json.dumps(req) + "\n")
        try:
            z.stdin.write("".join(lines).encode())
            z.stdin.flush()
        except (OSError, AttributeError):
            self._kill_zygote()
            return 0
        done = 0
        try:
            for _ in env_keys:
                pid = int(self._pipe_read_line(15.0).strip())
                # Copy-on-write rebind, NOT .add(): the memory-monitor
                # path iterates this set from the IO loop
                # (_is_zygote_child candidates), and a concurrent .add()
                # from this spawner thread is a "set changed size during
                # iteration" crash. Readers deref once and iterate the
                # immutable snapshot. Single-writer (spawner thread
                # only), so the read-modify-write below cannot lose
                # updates.
                self.zygote_pids = self.zygote_pids | {pid}  # raylint: disable=RTL151 (single-writer copy-on-write rebind; loop readers iterate the snapshot)
                done += 1
        except (OSError, ValueError, TimeoutError):
            # Template wedged or died mid-burst: kill it so the pipe
            # state can't go out of sync; the cold path covers the rest.
            self._kill_zygote()
        return done

    def _spawner_thread_main(self):
        import queue as _queue

        while True:
            item = self._spawn_q.get()
            if item is None:
                return
            batch = [item]
            # Coalesce the burst: everything already queued forks as one
            # pipelined batch.
            while True:
                try:
                    nxt = self._spawn_q.get_nowait()
                except _queue.Empty:
                    break
                if nxt is None:
                    return
                batch.append(nxt)
            ok = 0
            try:
                ok = self._spawn_batch_via_zygote(batch)
                for env_key in batch[ok:]:
                    self._spawn_cold(sys.executable, worker_sys_path(),
                                     env_key)
                    ok += 1
            except Exception as e:  # noqa: BLE001 — keep the spawner alive
                import logging

                logging.getLogger(__name__).exception("worker spawn failed")
                # Report every spawn that will never produce a worker:
                # the GCS frees its `spawning` slots (they are otherwise
                # only released by a worker hello) and re-runs scheduling.
                err = str(e)
                for _ in batch[ok:]:
                    self._loop.call_soon_threadsafe(
                        self._send_spawn_failed, err)

    def _spawn(self, python: str, sys_path: str, env_key: str, wrap=None):
        if self._zygote_available(python, wrap):
            # Queue for the spawner thread: the agent loop never blocks on
            # the zygote handshake (a stalled template must not
            # stop health-check replies and get the node declared dead).
            import queue as _queue
            import threading

            if self._spawn_q is None:
                self._spawn_q = _queue.SimpleQueue()
                self._spawner = threading.Thread(
                    target=self._spawner_thread_main, daemon=True)
                self._spawner.start()
            self._spawn_q.put(env_key)
            return
        self._spawn_cold(python, sys_path, env_key, wrap)

    def _spawn_cold(self, python: str, sys_path: str, env_key: str,
                    wrap=None):
        env = dict(os.environ)
        env.update(self.env_overrides)
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id.hex()
        env["RAY_TPU_TORCH_SYS_PATH"] = sys_path
        if env_key:
            env["RAY_TPU_TORCH_ENV_KEY"] = env_key
        else:
            env.pop("RAY_TPU_TORCH_ENV_KEY", None)
        # ``-S`` skips site processing (~2s in large venvs); the bootstrap
        # restores the parent's sys.path so imports resolve identically.
        argv = [python, "-S", "-c", _WORKER_BOOTSTRAP,
                "--gcs", self.gcs_address,
                "--node-id", self.node_id.hex(),
                "--session-dir", self.session_dir]
        if wrap is not None:
            # Container runtime env: the whole command runs inside
            # `podman/docker run` (runtime_env/container.py).
            argv, env = wrap(argv, env)
        proc = subprocess.Popen(
            argv,
            env=env,
            stdout=open(os.path.join(
                self.session_dir, f"worker-{len(self.procs)}.out"), "ab"),
            stderr=subprocess.STDOUT,
        )
        self.procs.append(proc)

    async def _on_msg(self, msg: dict):
        t = msg.get("t")
        if t is None:
            return  # empty/typeless frame: skip, never fall through
        if t == "spawn_worker":
            self.spawn_worker(msg.get("env_spec"), msg.get("env_key", ""))
        elif t == "health_check":
            # Active GCS liveness probe (GcsHealthCheckManager analog).
            self.conn.reply(msg, {"ok": True})
        elif t == "exit":
            self.stopped.set()

    async def _reap_loop(self):
        from ray_tpu_torch.util import events as plane_events

        while not self.stopped.is_set():
            for p in self.procs:
                p.poll()
            # Agent-side plane events (this process's chunk-serve
            # threads emit bcast rows) flush on the reap tick — agents
            # have no executor flush loop.
            if plane_events.pending() and self.conn is not None \
                    and not self.conn.closed:
                rows, drops = plane_events.drain()
                if rows or drops:
                    try:
                        self.conn.send({
                            "t": "plane_events", "ev": rows,
                            "drops": drops,
                            "nid": self.node_id.binary(),
                            "pid": os.getpid()})
                    except ConnectionError:
                        pass
            await asyncio.sleep(0.5)

    async def run_until_stopped(self):
        await self.stopped.wait()
        self.shutdown_workers()

    def shutdown_workers(self):
        if self._spawn_q is not None:
            self._spawn_q.put(None)  # retire the spawner thread
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        # Zygote-forked workers (own sessions, not in self.procs): same
        # terminate-then-kill guarantee, validated as LIVE children of
        # the zygote before signalling (pid recycling safety).
        live_forks = [p for p in set(self.zygote_pids)
                      if self._is_zygote_child(p)]
        for pid in live_forks:
            try:
                os.kill(pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                pass
        deadline = time.time() + 3
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.wait(max(0.0, deadline - time.time()))
                except subprocess.TimeoutExpired:
                    p.kill()
        for pid in live_forks:
            if self._is_zygote_child(pid):
                try:
                    os.kill(pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass
        z = self._zygote
        if z is not None and z.poll() is None:
            z.kill()
        self._zygote = None
        # Rebind, not .clear(): the spawner thread iterates the bound
        # snapshot (copy-on-write invariant at _spawn_batch_via_zygote).
        self.zygote_pids = set()


async def _orphan_watch(get_gcs):
    """Supervised head: exit once the spawning driver is gone (PPID
    reparented) and no drivers are connected."""
    spawner_ppid = os.getppid()
    while True:
        await asyncio.sleep(5.0)
        if os.getppid() == spawner_ppid:
            continue
        gcs = get_gcs()
        if any(not d.conn.closed for d in gcs.drivers):
            continue
        await asyncio.sleep(10.0)  # grace: a driver may be reconnecting
        gcs = get_gcs()
        if os.getppid() != spawner_ppid and not any(
                not d.conn.closed for d in gcs.drivers):
            import logging

            logging.getLogger(__name__).warning(
                "orphaned head (spawner died, no drivers): shutting down")
            for w in gcs.workers.values():
                if not w.conn.closed:
                    try:
                        w.conn.send({"t": "exit"})
                    except ConnectionError:
                        pass
            gcs._shutdown_event.set()
            return


async def head_amain(args):
    from .gcs import GcsServer

    resources = json.loads(args.resources)
    session_name = os.path.basename(args.session_dir)
    uds = "unix:" + os.path.join(args.session_dir, "gcs.sock")
    agent = None
    ready_written = False
    while True:
        # Supervisor loop: a GcsServer instance serves until shutdown OR a
        # (chaos-injected or operator) control-plane restart — the next
        # instance starts empty and recovers from WAL + arena + resyncs
        # (reference: GCS restarting from Redis, gcs_init_data.cc).
        gcs = GcsServer(session_name, args.session_dir,
                        store_capacity=int(resources.get(
                            "object_store_memory", DEFAULT_STORE_CAPACITY)))
        address = uds
        if args.port:
            # TCP for remote drivers/agents + the local UDS for same-host
            # workers (the reference similarly serves gRPC on a port while
            # workers register over a local socket, node_manager.h:119).
            # Bind loopback unless a host was explicitly provided: this
            # socket accepts unauthenticated task submission, so exposing
            # it on all interfaces must be an operator decision
            # (--host/host=), not a default.
            bind_host = args.host or "127.0.0.1"
            await gcs.start(f"{bind_host}:{args.port}", uds)
            adv_host = args.host or "127.0.0.1"
            if args.host in ("0.0.0.0", "::"):
                adv_host = get_node_ip_address()
            address = f"{adv_host}:{args.port}"
        else:
            await gcs.start(uds)
        if agent is None:
            agent = NodeAgent(
                uds, args.session_dir, resources,
                num_initial_workers=args.num_initial_workers,
                probe_gpu=not args.no_probe_gpu)
            await agent.start()
            if args.supervised:
                # Orphan cleanup (reference: subreaper, src/ray/util/
                # subreaper.cc): a head spawned BY a driver must not
                # outlive it — if that driver dies without a clean
                # shutdown (SIGKILL, test-runner timeout), PPID reparents
                # and we tear the session down once no drivers remain.
                asyncio.get_running_loop().create_task(
                    _orphan_watch(lambda: gcs))
        if not ready_written:
            # Signal readiness to the parent driver. Atomic rename: the
            # parent polls for existence and immediately reads the
            # (load-bearing) address.
            ready = os.path.join(args.session_dir, "gcs.ready")
            # Boot-time one-shot, <100 bytes, written before the GCS
            # serves any traffic.  # raylint: disable=RTL006
            with open(ready + ".tmp", "w") as f:  # raylint: disable=RTL006
                f.write(address)
            os.rename(ready + ".tmp", ready)
            ready_written = True
        try:
            await gcs.wait_shutdown()
        finally:
            if not gcs.restart_requested:
                agent.stopped.set()
                agent.shutdown_workers()
                if hasattr(gcs.store, "unlink"):
                    try:
                        gcs.store.unlink()
                    except Exception:
                        pass
        if not gcs.restart_requested:
            break
        await gcs.stop_serving()


def _run_with_optional_profile(coro_factory, tag: str):
    """Run the process main loop, optionally under cProfile.

    ``RAY_TPU_TORCH_PROFILE=<dir>`` dumps per-process ``.pstats`` files there —
    the framework's on-demand profiling hook (reference: py-spy/memray
    drivers in ``dashboard/modules/reporter/profile_manager.py``).
    """
    prof_dir = os.environ.get("RAY_TPU_TORCH_PROFILE")
    if not prof_dir:
        asyncio.run(coro_factory())
        return
    import cProfile

    prof = cProfile.Profile()

    def _dump():
        prof.disable()
        os.makedirs(prof_dir, exist_ok=True)
        prof.dump_stats(os.path.join(prof_dir, f"{tag}_{os.getpid()}.pstats"))

    # Workers hard-exit (os._exit skips finally/atexit): expose the dump
    # so worker_main can flush the profile right before exiting.
    global _profile_dump
    _profile_dump = _dump
    prof.enable()
    try:
        asyncio.run(coro_factory())
    finally:
        _profile_dump = None
        _dump()


_profile_dump = None


def _session_logging_config():
    """Session-process log setup honoring ``ray_tpu_torch.LoggingConfig``:
    RAY_TPU_TORCH_LOG_LEVEL picks the level, RAY_TPU_TORCH_LOG_ENCODING=JSON swaps
    the line format for one-JSON-object-per-line (reference:
    ``ray.LoggingConfig`` structured logging)."""
    import logging

    level = os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO")
    if os.environ.get("RAY_TPU_TORCH_LOG_ENCODING") == "JSON":
        class _J(logging.Formatter):
            def format(self, rec):
                return json.dumps({
                    "ts": self.formatTime(rec), "level": rec.levelname,
                    "logger": rec.name, "msg": rec.getMessage()})

        h = logging.StreamHandler()
        h.setFormatter(_J())
        logging.basicConfig(level=level, handlers=[h])
    else:
        logging.basicConfig(
            level=level,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def head_main():
    import argparse

    _session_logging_config()
    parser = argparse.ArgumentParser()
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--resources", required=True)
    parser.add_argument("--num-initial-workers", type=int, default=2)
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--host", default="")
    parser.add_argument("--no-probe-gpu", action="store_true")
    parser.add_argument("--supervised", action="store_true")
    args = parser.parse_args()
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    _run_with_optional_profile(lambda: head_amain(args), "head")


async def agent_amain(args):
    resources = json.loads(args.resources)
    # The launcher (autoscaler provider / cluster_utils) pre-assigns the node
    # id via env so it can map instances to registered nodes.
    node_id_hex = os.environ.get("RAY_TPU_TORCH_NODE_ID")
    agent = NodeAgent(args.gcs, args.session_dir, resources,
                      node_id=NodeID(bytes.fromhex(node_id_hex))
                      if node_id_hex else None,
                      num_initial_workers=args.num_initial_workers,
                      env_overrides=json.loads(args.env or "{}"))
    await agent.start()
    await agent.run_until_stopped()


def agent_main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--resources", required=True)
    parser.add_argument("--num-initial-workers", type=int, default=1)
    parser.add_argument("--env", default="{}")
    args = parser.parse_args()
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))
    _run_with_optional_profile(lambda: agent_amain(args), "agent")


class HeadNode:
    """Driver-side handle that spawns and supervises the head process."""

    def __init__(self, num_cpus=None, num_gpus=None, resources=None,
                 num_initial_workers: int = 2, probe_gpu: bool = True,
                 port: int = 0, host: str = ""):
        self.session_dir = new_session_dir()
        self.resources = detect_node_resources(num_cpus, num_gpus, resources)
        self.address = "unix:" + os.path.join(self.session_dir, "gcs.sock")
        self.tcp_address: Optional[str] = None
        cmd = [sys.executable, "-S", "-c", _HEAD_BOOTSTRAP,
               "--session-dir", self.session_dir,
               "--resources", json.dumps(self.resources),
               "--num-initial-workers", str(num_initial_workers)]
        if port:
            cmd += ["--port", str(port)]
        if host:
            cmd += ["--host", host]
        cmd.append("--supervised")  # driver-spawned: die if orphaned
        if not probe_gpu:
            cmd.append("--no-probe-gpu")
        env = {**os.environ, "RAY_TPU_TORCH_SYS_PATH": worker_sys_path()}
        self.proc = subprocess.Popen(
            cmd,
            start_new_session=True,
            env=env,
            stdout=open(os.path.join(self.session_dir, "gcs.out"), "ab"),
            stderr=subprocess.STDOUT)
        ready = os.path.join(self.session_dir, "gcs.ready")
        deadline = time.time() + 30
        from .backoff import Backoff

        poll = Backoff(base=0.005, cap=0.1, jitter=0.0)
        while not os.path.exists(ready):
            if self.proc.poll() is not None:
                out = open(os.path.join(self.session_dir, "gcs.out")).read()
                raise RuntimeError(f"head process failed to start:\n{out}")
            if time.time() > deadline:
                raise TimeoutError("timed out waiting for the head process")
            time.sleep(poll.next_delay())
        if port:
            self.tcp_address = open(ready).read().strip() or None

    def stop(self):
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            try:
                self.proc.wait(5)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(self.proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        # Best-effort cleanup of leaked shm segments for this session:
        # per-object segments (PyShmStore) and the native arena.
        import hashlib

        session = os.path.basename(self.session_dir)
        tag = hashlib.sha1(session.encode()).hexdigest()[:16]
        shm_dir = "/dev/shm"
        try:
            for name in os.listdir(shm_dir):
                if name.startswith("rtpt") and (session[-8:] in name
                                                or tag in name):
                    try:
                        os.unlink(os.path.join(shm_dir, name))
                    except OSError:
                        pass
        except OSError:
            pass
