"""Tenant SLO registry, interference detector, and enforcement ladder.

The flight recorder measures exactly the signals a reactive
control plane needs — tenant-tagged request latencies, step times,
admission block/unblock events, broadcast chunk accounting, rollout
egress — but until now every scheduling/admission decision was a static
threshold. This module closes ROADMAP open item 3: a GCS-side control
loop that evaluates per-tenant SLO specs over a sliding window of
plane-event rows, attributes a measured breach to an offending tenant's
traffic class, and walks a BOUNDED action ladder against the offender:

  rung 1  re-weight   offender's fair-ingress slice + admission budget
                      scale by ``slo_reweight_factor`` (floor 1 frame /
                      cycle — starvation is migration's job)
  rung 2  rebalance   up to ``slo_rebalance_max_leases`` of the
                      offender's held worker leases revoked gracefully
                      (the ``_rebalance_leases`` semantics, targeted)
  rung 3  migrate     the node with the greatest offender presence is
                      drained via the drain path (restartable
                      work migrates, the offender's placement moves
                      off the victim's hardware)

Hysteresis, both directions: ``breach_windows`` CONSECUTIVE breached
sweeps are required before any action, ``recover_windows`` consecutive
clear sweeps before de-escalation (weight restored, ladder reset), and
``slo_action_cooldown_s`` separates any two actions against the same
offender so the cluster can show a rung's effect before the next rung
fires. Every transition is journaled as a plane event — ``slo.*`` rows
are the cause journal, ``enforce.*`` rows the action journal — so
``timeline --planes`` proves breach -> attribution -> action ->
recovery on one clock, and the ``gcs.slo.enforce`` failpoint site fires
per action so chaos schedules can kill/delay the control plane at the
exact enforcement boundary.

Spec format (JSON value of the ``slo_specs`` config flag, or registered
live through ``ray_tpu_torch.util.slo.register``)::

    {"<tenant>": {"event": "serve.req.done",   # plane-event name
                  "field": "dur",              # "dur" or a fields key
                  "stat": "p99",               # p99 | p95 | p50 | mean | max
                  "threshold_s": 0.05,         # breach above this
                  "breach_windows": 3,         # sweeps before acting
                  "recover_windows": 3,        # sweeps before resetting
                  "min_samples": 5}}           # below this: no verdict

Serve tenants point at ``serve.req.done`` durations; train/RL tenants
point at their step rows (e.g. ``rl.update.step`` durations) — the
detector is generic over (event, field, stat).
"""

from __future__ import annotations

import json
import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import events as plane_events

logger = logging.getLogger(__name__)

RUNGS = ("reweight", "rebalance", "migrate")

_SPEC_DEFAULTS = {
    "event": "serve.req.done",
    "field": "dur",
    "stat": "p99",
    "threshold_s": 0.1,
    "breach_windows": 3,
    "recover_windows": 3,
    "min_samples": 5,
}

# Attribution class -> the event names whose tenant-tagged volume in the
# window scores a candidate offender. Scores mix byte volume with event
# counts (x1000 — a control-frame flood carries few bytes but each row
# is loop occupancy) plus LIVE driver-lane queue depth for the ingress
# class; the winner only needs to be the argmax, not calibrated.
_CAUSE_EVENTS = {
    "broadcast_refresh": ("bcast.chunk.serve", "bcast.chunk.claim",
                          "bcast.chunk.steal"),
    "rollout_egress": ("rl.rollout.push", "rl.weights.pull"),
    "ingress_flood": ("gcs.admission.block",),
}

# A control-frame flood that the fair-ingress drain fully absorbs leaves
# NO standing queue and NO admission blocks (measured: 130k frames/s
# from one lane, queue depth 0 at every sample instant) — the loop
# occupancy it steals shows up only as the lane's frame arrival RATE.
# Drivers below this rate (frames/s) are never scored as flood.
_FLOOD_RATE_FLOOR = 100.0


def _stat(values: List[float], stat: str) -> float:
    values = sorted(values)
    n = len(values)
    if stat == "mean":
        return sum(values) / n
    if stat == "max":
        return values[-1]
    q = {"p99": 0.99, "p95": 0.95, "p50": 0.50}.get(stat, 0.99)
    return values[min(n - 1, int(q * n))]


def normalize_spec(raw: Dict[str, Any]) -> Dict[str, Any]:
    spec = dict(_SPEC_DEFAULTS)
    spec.update({k: raw[k] for k in _SPEC_DEFAULTS if k in raw})
    spec["threshold_s"] = float(spec["threshold_s"])
    for k in ("breach_windows", "recover_windows", "min_samples"):
        spec[k] = max(1, int(spec[k]))
    return spec


class _TenantSlo:
    """Per-victim detector state (streaks are the hysteresis memory)."""

    __slots__ = ("spec", "breach_streak", "clear_streak", "breached",
                 "last_value", "last_samples", "offender")

    def __init__(self, spec: Dict[str, Any]):
        self.spec = spec
        self.breach_streak = 0
        self.clear_streak = 0
        self.breached = False      # an enforcement cycle is open
        self.last_value = 0.0
        self.last_samples = 0
        self.offender = ""         # attributed tenant while breached


class _Offender:
    """Per-offender ladder state (shared across victims: two breached
    tenants pointing at one offender walk ONE ladder, not two)."""

    __slots__ = ("rung", "last_action", "weighted")

    def __init__(self):
        self.rung = 0              # rungs applied so far (0..len(RUNGS))
        self.last_action = 0.0
        self.weighted = False


class SloController:
    """Owns specs, detector state, and the enforcement ladder. Lives on
    the GCS instance; ``sweep()`` runs on the ``_slo_loop`` timer inside
    the control-plane event loop (no locking — same-loop access only).
    """

    def __init__(self, gcs):
        self.gcs = gcs
        from .config import config as _cfg

        c = _cfg()
        self.sweep_interval = max(0.05, float(c.slo_sweep_interval_s))
        self.window_s = max(self.sweep_interval, float(c.slo_window_s))
        self.cooldown_s = max(0.0, float(c.slo_action_cooldown_s))
        self.reweight_factor = min(1.0, max(0.001,
                                            float(c.slo_reweight_factor)))
        self.rebalance_max = max(1, int(c.slo_rebalance_max_leases))
        self.tenants: Dict[str, _TenantSlo] = {}
        self.offenders: Dict[str, _Offender] = {}
        self.actions: deque = deque(maxlen=256)  # journal mirror (stats)
        self.counters = {"sweeps": 0, "breaches": 0, "recoveries": 0,
                         "actions": 0, "forced": 0}
        self._frame_marks: Dict[int, tuple] = {}  # serial -> (ts, frames)
        self._frame_rates: Dict[str, float] = {}  # tenant -> frames/s
        try:
            for tenant, raw in json.loads(c.slo_specs or "{}").items():
                self.tenants[tenant] = _TenantSlo(normalize_spec(raw))
        except (ValueError, AttributeError, TypeError):
            logger.warning("malformed slo_specs JSON ignored: %r",
                           c.slo_specs)

    # ------------------------------------------------------------- registry

    def register(self, tenant: str, raw: Dict[str, Any]) -> Dict[str, Any]:
        spec = normalize_spec(raw)
        cur = self.tenants.get(tenant)
        if cur is not None:
            cur.spec = spec          # live update keeps streak state
        else:
            self.tenants[tenant] = _TenantSlo(spec)
        return spec

    def unregister(self, tenant: str) -> bool:
        return self.tenants.pop(tenant, None) is not None

    def status(self) -> Dict[str, Any]:
        return {
            "tenants": {
                t: {"spec": s.spec, "breached": s.breached,
                    "breach_streak": s.breach_streak,
                    "clear_streak": s.clear_streak,
                    "last_value": round(s.last_value, 6),
                    "last_samples": s.last_samples,
                    "offender": s.offender}
                for t, s in self.tenants.items()},
            "offenders": {
                o: {"rung": st.rung,
                    "rungs_applied": list(RUNGS[:st.rung]),
                    "weighted": st.weighted,
                    "weight": self.gcs._tenant_weights.get(o, 1.0)}
                for o, st in self.offenders.items()},
            "weights": dict(self.gcs._tenant_weights),
            "frame_rates": {ns: round(r, 1)
                            for ns, r in self._frame_rates.items()},
            "actions": list(self.actions),
            "counters": dict(self.counters),
            "window_s": self.window_s,
            "sweep_interval_s": self.sweep_interval,
        }

    # ------------------------------------------------------------- detector

    def _window_rows(self, now: float) -> List[list]:
        horizon = now - self.window_s
        out = []
        for _nid, _pid, row in self.gcs.plane_events:
            if row[0] >= horizon:
                out.append(row)
        return out

    def _evaluate(self, tenant: str, slo: _TenantSlo,
                  rows: List[list]) -> Optional[bool]:
        """One sweep's verdict for one tenant: True breached, False
        clear, None no-verdict (insufficient samples — a tenant that
        went quiet neither breaches nor recovers)."""
        spec = slo.spec
        name, field = spec["event"], spec["field"]
        values: List[float] = []
        for row in rows:
            if row[1] != name or row[3] != tenant:
                continue
            if field == "dur":
                values.append(row[5])
            else:
                v = (row[6] or {}).get(field)
                if v is not None:
                    values.append(float(v))
        slo.last_samples = len(values)
        if len(values) < spec["min_samples"]:
            return None
        slo.last_value = _stat(values, spec["stat"])
        return slo.last_value > spec["threshold_s"]

    def _sample_frame_rates(self, now: float):
        """Per-tenant driver frame arrival rate since the LAST sweep
        (serial-keyed marks survive tenants sharing a namespace). Runs
        once per sweep; ``_attribute`` reads the cached rates."""
        rates: Dict[str, float] = {}
        new_marks: Dict[int, tuple] = {}
        for c in self.gcs.drivers:
            if c.conn is None or getattr(c.conn, "closed", False):
                continue
            frames = getattr(c.conn, "frames_in", 0)
            new_marks[c.serial] = (now, frames)
            prev = self._frame_marks.get(c.serial)
            if prev is None or now - prev[0] <= 0:
                continue
            ns = c.namespace or "default"
            rate = (frames - prev[1]) / (now - prev[0])
            rates[ns] = rates.get(ns, 0.0) + max(0.0, rate)
        self._frame_marks = new_marks
        self._frame_rates = rates

    def _attribute(self, victim: str, rows: List[list]) -> tuple:
        """(offender, cause, score): argmax over (tenant, class) volume
        in the window. Two LIVE signals join the ingress class beyond
        journaled block events: standing driver-lane queue depth, and
        the per-tenant frame arrival rate — a control-frame flood the
        fair-ingress drain fully absorbs leaves no queue and no block
        rows, only loop occupancy proportional to its frame rate."""
        scores: Dict[tuple, float] = {}
        by_event: Dict[str, str] = {n: cls for cls, names
                                    in _CAUSE_EVENTS.items() for n in names}
        for row in rows:
            cls = by_event.get(row[1])
            tenant = row[3]
            if cls is None or not tenant or tenant == victim:
                continue
            f = row[6] or {}
            nbytes = float(f.get("bytes") or f.get("nbytes") or 0.0)
            k = (tenant, cls)
            scores[k] = scores.get(k, 0.0) + nbytes + 1000.0
        for c in self.gcs.drivers:
            ns = c.namespace or "default"
            if ns == victim or c.conn is None or c.conn.closed:
                continue
            depth = len(c.inq)
            if depth:
                k = (ns, "ingress_flood")
                scores[k] = scores.get(k, 0.0) + float(depth)
        for ns, rate in self._frame_rates.items():
            if ns == victim or rate < _FLOOD_RATE_FLOOR:
                continue
            k = (ns, "ingress_flood")
            scores[k] = scores.get(k, 0.0) + rate
        if not scores:
            return "", "", 0.0
        (tenant, cls), score = max(scores.items(), key=lambda kv: kv[1])
        return tenant, cls, score

    # ------------------------------------------------------------- ladder

    def _apply_rung(self, rung: str, offender: str, victim: str,
                    now: float, forced: bool = False) -> Dict[str, Any]:
        """Execute one enforcement action and journal it. Returns the
        action record (also mirrored into ``status()['actions']``)."""
        # Chaos boundary: a schedule can kill/delay/crash the control
        # plane exactly between deciding an action and applying it.
        self.gcs._fp("gcs.slo.enforce", key=rung)
        rec = {"ts": now, "rung": rung, "offender": offender,
               "victim": victim, "forced": bool(forced)}
        if rung == "reweight":
            self.gcs._tenant_weights[offender] = self.reweight_factor
            self.offenders.setdefault(offender, _Offender()).weighted = True
            plane_events.emit("enforce.weight.apply", plane="enforce",
                              tenant=offender, victim=victim,
                              factor=self.reweight_factor,
                              forced=int(forced))
        elif rung == "rebalance":
            revoked = self.gcs._rebalance_against(offender,
                                                  self.rebalance_max)
            rec["revoked"] = revoked
            plane_events.emit("enforce.lease.revoke", plane="enforce",
                              tenant=offender, victim=victim,
                              revoked=revoked, forced=int(forced))
        elif rung == "migrate":
            node_hex = self.gcs._migrate_tenant(offender, victim)
            rec["node"] = node_hex
            plane_events.emit("enforce.node.drain", plane="enforce",
                              tenant=offender, victim=victim,
                              node=node_hex, forced=int(forced))
        else:
            raise ValueError(f"unknown enforcement rung {rung!r}")
        self.actions.append(rec)
        self.counters["actions"] += 1
        if forced:
            self.counters["forced"] += 1
        return rec

    def _escalate(self, victim: str, slo: _TenantSlo, now: float):
        offender = slo.offender
        st = self.offenders.setdefault(offender, _Offender())
        if st.rung >= len(RUNGS):
            return                       # ladder exhausted: migrate was it
        if now - st.last_action < self.cooldown_s:
            return                       # let the last rung show effect
        rung = RUNGS[st.rung]
        st.rung += 1
        st.last_action = now
        try:
            self._apply_rung(rung, offender, victim, now)
        except Exception:
            # A failpoint (or drain refusal) unwinding here must not
            # wedge the ladder: the rung stays counted, the next sweep
            # continues from the following rung after the cooldown.
            logger.exception("enforcement rung %s against %s failed",
                             rung, offender)

    def _de_escalate(self, victim: str, slo: _TenantSlo, now: float):
        offender = slo.offender
        st = self.offenders.get(offender)
        if st is not None and st.weighted:
            self.gcs._tenant_weights.pop(offender, None)
            st.weighted = False
            plane_events.emit("enforce.weight.restore", plane="enforce",
                              tenant=offender, victim=victim)
        if st is not None:
            st.rung = 0
        plane_events.emit("slo.breach.clear", plane="slo", tenant=victim,
                          offender=offender, value=slo.last_value)
        self.counters["recoveries"] += 1
        slo.breached = False
        slo.offender = ""
        slo.breach_streak = 0
        slo.clear_streak = 0

    # ------------------------------------------------------------- sweep

    def sweep(self, now: Optional[float] = None):
        """One detector pass: evaluate every registered spec over the
        window, advance hysteresis streaks, escalate/de-escalate."""
        if not self.tenants:
            return
        now = time.time() if now is None else now
        self.counters["sweeps"] += 1
        self._sample_frame_rates(now)
        rows = self._window_rows(now)
        for tenant, slo in self.tenants.items():
            verdict = self._evaluate(tenant, slo, rows)
            if verdict is None:
                continue
            if verdict:
                slo.breach_streak += 1
                slo.clear_streak = 0
                if slo.breach_streak < slo.spec["breach_windows"]:
                    continue
                if not slo.breached:
                    slo.breached = True
                    self.counters["breaches"] += 1
                    plane_events.emit(
                        "slo.breach.detect", plane="slo", tenant=tenant,
                        value=slo.last_value,
                        threshold=slo.spec["threshold_s"],
                        stat=slo.spec["stat"], samples=slo.last_samples)
                if not slo.offender:
                    # Attribution can miss at breach open (the offending
                    # lane's queue sampled empty at that instant, its
                    # cause rows not yet flushed): keep attributing
                    # while the breach stays open — the journal records
                    # the sweep that finally pinned it.
                    offender, cause, score = self._attribute(tenant, rows)
                    if offender:
                        slo.offender = offender
                        plane_events.emit(
                            "slo.breach.attribute", plane="slo",
                            tenant=tenant, offender=offender, cause=cause,
                            score=round(score, 1))
                if slo.offender:
                    self._escalate(tenant, slo, now)
            else:
                slo.clear_streak += 1
                slo.breach_streak = 0
                if slo.breached \
                        and slo.clear_streak >= slo.spec["recover_windows"]:
                    self._de_escalate(tenant, slo, now)

    # ------------------------------------------------------------- force

    def force(self, rung: str, offender: str,
              victim: str = "") -> Dict[str, Any]:
        """Test/drill hook (``slo_force`` op): execute one rung NOW,
        journaled exactly like a detector-driven action (forced=1 in the
        row fields tells the certificate reader apart). The tier-1 soak
        smoke uses this for its deterministic enforcement action."""
        if rung not in RUNGS:
            raise ValueError(f"rung must be one of {RUNGS}, got {rung!r}")
        now = time.time()
        st = self.offenders.setdefault(offender, _Offender())
        st.last_action = now
        st.rung = max(st.rung, RUNGS.index(rung) + 1)
        return self._apply_rung(rung, offender, victim, now, forced=True)

    def restore(self, offender: str) -> bool:
        """Undo a (forced) re-weight without waiting for recover
        hysteresis — the drill cleanup path."""
        st = self.offenders.get(offender)
        had = self.gcs._tenant_weights.pop(offender, None) is not None
        if st is not None:
            st.weighted = False
            st.rung = 0
        if had:
            plane_events.emit("enforce.weight.restore", plane="enforce",
                              tenant=offender)
        return had
