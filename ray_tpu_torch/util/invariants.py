"""End-state invariants for chaos certification.

The checks every seeded fault schedule must leave intact, shared between
the pytest ``invariants`` fixture (tests/conftest.py, opt-in marker) and
``benchmarks/chaos_suite.py`` — ONE invariant core, so a workload that
passes the suite passes the tests for the same reasons.

Two layers:

* :func:`check_cluster_invariants` — against the LIVE cluster: GCS
  ingress lanes drained (no parked frames, no stuck backpressure),
  tenant quota usage returned to zero, no workers wedged busy, object
  refcounts back at the pre-workload level.
* :func:`check_host_invariants` — after shutdown: no orphaned session
  processes (a worker/agent reparented to init is a leak — its session
  is gone), and the session's /dev/shm arena actually unlinked.
* :func:`periodic_sweep` / :class:`PeriodicSweeper` — the MID-RUN
  subset, run continuously while a long workload is still hot (the
  chaos runner and the soak harness both ride this): lanes and usage
  are legitimately non-zero mid-run, so the sweep checks what must hold
  AT EVERY INSTANT — usage within quota caps, drop counters reported
  and bounded, retention honored, no orphaned session processes — and
  journals each pass (and each violation, with its timestamp) as
  ``slo.invariant.*`` plane events so the certificate's timeline shows
  when an invariant broke, not just that it did by exit.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Callable, List, Optional


class InvariantViolation(AssertionError):
    """A chaos end-state invariant failed. Message carries the fired
    failpoint schedule when one is armed (repro ergonomics)."""


def _fail(msg: str):
    from ray_tpu_torch._private import failpoints

    raise InvariantViolation(f"{msg}\n{failpoints.format_schedule()}")


def arena_paths(session_name: str) -> List[str]:
    """The /dev/shm paths a session's native arena can live at (the
    PyShm fallback's per-object segments carry the session name and are
    matched by prefix in :func:`check_host_invariants`)."""
    tag = hashlib.sha1(session_name.encode()).hexdigest()[:16]
    return [f"/dev/shm/rtpt_{tag}"]


def _gcs_stats(w) -> dict:
    reply = w.request_gcs({"t": "gcs_stats"}, timeout=10)
    if not reply.get("ok"):
        _fail(f"gcs_stats failed: {reply.get('err')}")
    return reply


def check_cluster_invariants(*, baseline_refs: Optional[int] = None,
                             timeout: float = 15.0) -> dict:
    """Assert the live cluster drained back to a clean steady state.

    Retries until ``timeout``: deref frames flush on 0.1s ticks, leases
    idle-return after 0.25s, and post-chaos reconnects may still be in
    flight — the invariant is about the CONVERGED state, not an instant.
    Returns the final ``gcs_stats`` reply for caller-side extras.
    """
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import state

    w = global_worker()
    deadline = time.time() + timeout
    last = ""
    while True:
        try:
            stats = _gcs_stats(w)
            problems = []
            for row in stats.get("ingress", []):
                if row.get("queued"):
                    problems.append(f"lane not drained: {row}")
                if row.get("backpressured"):
                    problems.append(f"stuck backpressure: {row}")
            usage = stats.get("tenant_usage") or {}
            for ns, used in usage.items():
                if any(abs(v) > 1e-6 for v in used.values()):
                    problems.append(f"tenant {ns!r} usage not zero: {used}")
            gangs = stats.get("gangs") or {}
            if gangs:
                # Every WorkerGroup deregisters on shutdown (and driver
                # exit GCs the rest): a surviving record is a leaked
                # gang — its channel keeps publishing into the void.
                problems.append(f"gang records not retired: {gangs}")
            pe = stats.get("plane_events")
            if pe is None or "drops" not in pe:
                # The flight recorder's end-state surface is part of the
                # contract: drop counters must be REPORTED (present even
                # when all-zero) so a chaos run can't silently lose the
                # overflow signal.
                problems.append("plane_events stats missing from "
                                "gcs_stats (drop counters unreported)")
            elif pe["oldest_age_s"] > pe["retention_s"] + 30.0:
                # Slack: the retention sweep rides the GCS health tick
                # (health_check_interval_s, default 5s) — one missed
                # tick is fine, a table aging far past its window means
                # the sweep is dead.
                problems.append(
                    f"plane-event table beyond retention: oldest row "
                    f"{pe['oldest_age_s']:.1f}s old vs "
                    f"{pe['retention_s']:.0f}s window")
            stuck = [wk for wk in state.list_workers()
                     if wk.get("state") == "busy"]
            if stuck:
                problems.append(f"workers wedged busy: {stuck}")
            if baseline_refs is not None:
                live = sum(1 for o in state.list_objects()
                           if o.get("refcount", 0) > 0)
                if live > baseline_refs:
                    problems.append(
                        f"refcounts not drained: {live} live objects "
                        f"(baseline {baseline_refs})")
            if not problems:
                return stats
            last = "; ".join(problems)
        except InvariantViolation:
            raise
        except Exception as e:  # transient (reconnect in flight)
            last = f"stats unavailable: {e}"
        if time.time() > deadline:
            _fail(f"cluster invariants violated after {timeout:.0f}s: "
                  f"{last}")
        time.sleep(0.25)


def live_ref_count() -> int:
    """Objects with refcount > 0 right now — the workload baseline for
    the refcounts-drained invariant."""
    from ray_tpu_torch.util import state

    return sum(1 for o in state.list_objects()
               if o.get("refcount", 0) > 0)


def _session_procs() -> List[dict]:
    """ray_tpu_torch session processes (workers/agents/heads) on this host
    that were ORPHANED — reparented to init because their supervisor
    died without reaping them. Live clusters keep proper parent chains,
    so ppid==1 is the leak signal that stays valid while OTHER tests'
    clusters are up."""
    out = []
    markers = ("ray_tpu_torch._private.worker_main",
               "ray_tpu_torch._private.agent_entry",
               "ray_tpu_torch._private.head_entry")
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            if not any(m in cmd for m in markers):
                continue
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().split(")")[-1].split()[1])
            out.append({"pid": int(pid), "ppid": ppid, "cmd": cmd[:160]})
        except (OSError, ValueError, IndexError):
            continue
    return [p for p in out if p["ppid"] == 1]


def orphaned_session_procs() -> List[dict]:
    """Public face of the ppid==1 orphan scan — used by the conftest
    pre-flight (stale zygotes from earlier hard-killed runs red out the
    chaos tier host-wide) as well as the post-shutdown host check."""
    return _session_procs()


def periodic_sweep(*, max_drops: int = 0,
                   raise_on_violation: bool = False) -> dict:
    """One mid-run invariant pass against the live cluster.

    The end-state core (:func:`check_cluster_invariants`) asserts the
    DRAINED state — lanes empty, usage zero — which is exactly wrong
    while a workload is hot. This sweep checks what must hold at every
    instant of a healthy run:

    * per-tenant quota usage never exceeds its cap (an over-charge
      mid-run is an accounting bug no amount of draining excuses);
    * the flight recorder's drop counters are REPORTED, and within
      ``max_drops`` (0 = any drop is a violation — the soak's bounded-
      drop certificate);
    * the plane-event table honors its retention window (sweep alive);
    * no session process has been orphaned to init on this host.

    Returns ``{"ts", "ok", "violations": [..], "stats": gcs_stats}``
    and journals the pass as a ``slo.invariant.pass`` /
    ``slo.invariant.violate`` plane event — per-sweep violation
    timestamps land in the same journal the breach/enforcement rows
    use, on the same clock. With ``raise_on_violation`` the first bad
    sweep raises :class:`InvariantViolation` instead of recording."""
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util import events as plane_events

    now = time.time()
    violations: List[str] = []
    stats: dict = {}
    try:
        stats = _gcs_stats(global_worker())
    except Exception as e:   # mid-chaos: GCS restarting is not a breach
        return {"ts": now, "ok": True, "skipped": f"stats unavailable: {e}",
                "violations": []}
    caps = stats.get("tenant_quotas") or {}
    for ns, used in (stats.get("tenant_usage") or {}).items():
        cap = caps.get(ns)
        if not cap:
            continue
        for k, v in used.items():
            if k in cap and v > cap[k] + 1e-6:
                violations.append(
                    f"tenant {ns!r} over quota: {k}={v} > cap {cap[k]}")
    pe = stats.get("plane_events")
    if pe is None or "drops" not in pe:
        violations.append("plane-event drop counters unreported")
    else:
        dropped = sum(pe["drops"].values())
        if dropped > max_drops:
            violations.append(
                f"plane-event drops beyond bound: {dropped} > "
                f"{max_drops} ({pe['drops']})")
        if pe["oldest_age_s"] > pe["retention_s"] + 30.0:
            violations.append(
                f"plane-event retention dead: oldest row "
                f"{pe['oldest_age_s']:.1f}s vs {pe['retention_s']:.0f}s")
    orphans = _session_procs()
    if orphans:
        violations.append(f"orphaned session processes: {orphans}")
    if violations:
        for v in violations:
            plane_events.emit("slo.invariant.violate", plane="slo",
                              detail=v[:240])
        if raise_on_violation:
            _fail("periodic sweep violated: " + "; ".join(violations))
    else:
        plane_events.emit("slo.invariant.pass", plane="slo")
    return {"ts": now, "ok": not violations, "violations": violations,
            "stats": stats}


class PeriodicSweeper:
    """Background driver for :func:`periodic_sweep` — the continuous
    arm of the invariant core. Start it next to a long workload, stop
    it before the end-state check; ``result()`` summarizes every sweep
    (count, violations with timestamps) for the run's certificate::

        sw = PeriodicSweeper(interval_s=2.0).start()
        ... hours of workload ...
        summary = sw.stop()
        assert summary["violations"] == []
    """

    def __init__(self, interval_s: float = 2.0, max_drops: int = 0,
                 on_violation: Optional[Callable[[dict], None]] = None):
        self.interval_s = max(0.1, float(interval_s))
        self.max_drops = int(max_drops)
        self.on_violation = on_violation
        self.sweeps = 0
        self.skipped = 0
        self.violations: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "PeriodicSweeper":
        self._thread = threading.Thread(
            target=self._run, name="invariant-sweeper", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                row = periodic_sweep(max_drops=self.max_drops)
            except Exception as e:   # never kill the workload from here
                row = {"ts": time.time(), "ok": True,
                       "skipped": f"sweep error: {e}", "violations": []}
            if row.get("skipped"):
                self.skipped += 1
                continue
            self.sweeps += 1
            for v in row["violations"]:
                rec = {"ts": row["ts"], "violation": v}
                self.violations.append(rec)
                if self.on_violation is not None:
                    self.on_violation(rec)

    def stop(self, timeout: float = 10.0) -> dict:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        return self.result()

    def result(self) -> dict:
        return {"sweeps": self.sweeps, "skipped": self.skipped,
                "interval_s": self.interval_s,
                "violations": list(self.violations)}


def check_host_invariants(session_name: Optional[str] = None,
                          timeout: float = 10.0) -> None:
    """Post-shutdown host state: no orphaned session processes, and the
    session's shm arena (plus any per-object PyShm segments) unlinked.
    Retried briefly — shutdown reaps children asynchronously."""
    deadline = time.time() + timeout
    while True:
        problems = []
        orphans = _session_procs()
        if orphans:
            problems.append(f"orphaned session processes: {orphans}")
        if session_name:
            for path in arena_paths(session_name):
                if os.path.exists(path):
                    problems.append(f"arena not unlinked: {path}")
            try:
                leaked = [n for n in os.listdir("/dev/shm")
                          if session_name in n]
            except OSError:
                leaked = []
            if leaked:
                problems.append(
                    f"leaked shm segments: {sorted(leaked)[:8]}")
        if not problems:
            return
        if time.time() > deadline:
            _fail("host invariants violated after shutdown: "
                  + "; ".join(problems))
        time.sleep(0.25)
