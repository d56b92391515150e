"""Deterministic failpoint registry: named, seed-scheduled fault injection.

Reference analog: the C++ chaos hooks (``src/ray/common/ray_syncer`` test
failure injection and ``rpc_chaos.h``'s env-driven RPC failures) plus the
``FAILPOINTS``-style registries of TiKV/etcd. The PR-3..6 planes (direct
arg lane, chunk-striped broadcast, wait groups, sharded multi-tenant GCS)
each ship fast paths whose failure behavior was only spot-tested; this
module gives every plane boundary a NAMED injection site that a seeded
schedule can drive deterministically, so a red chaos run is reproducible
from its printed seed + spec alone.

Spec grammar (``RAY_TPU_TORCH_FAILPOINTS`` env var or the ``failpoints`` config
flag; env wins so a single process can opt in under a cluster config)::

    site=trigger:action[:param][;site2=...]

Triggers
    ``once``      fire on the first hit only
    ``hitK``      fire on the K-th hit only (``hit3``)
    ``everyK``    fire on every K-th hit (``every2``)
    ``pX``        fire with probability X per hit, from a per-site RNG
                  seeded by (global seed, site) — same seed, same schedule

Actions
    ``raise``       raise :class:`FailpointError` (a ``ConnectionError``
                    subclass — transport retry paths must absorb it)
    ``delay``       block for ``param`` seconds (default 0.05) — simulates
                    a stalled peer / loop hiccup
    ``kill``        SIGKILL the CURRENT process (worker-kill sites)
    ``drop``        returned to the caller: silently drop the frame
    ``short``       returned to the caller: truncate the payload mid-write
                    and hard-close (disconnect mid-SG-payload)
    ``disconnect``  returned to the caller: close the connection before
                    the write
    ``crash``       returned to the caller: GCS sites translate this into
                    an in-place crash-restart (WAL + arena survive, all
                    in-memory state is discarded)

Sites are dotted names (``conn.send``, ``gcs.wal.before``). ``fire(site,
key)`` first matches the qualified ``site.key`` (e.g.
``conn.send.actor_call``), then the bare site, so a spec can target one
message type or a whole boundary. The fast path — no failpoints armed —
is a single dict check.

Every fired point is journaled ``(seq, pid, site, action)``; the chaos
suite prints the seed + journal on any failure so every red run is
one-command reproducible (satellite: chaos repro ergonomics).
"""

from __future__ import annotations

import logging
import os
import random
import signal
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

ENV_SPEC = "RAY_TPU_TORCH_FAILPOINTS"
ENV_SEED = "RAY_TPU_TORCH_FAILPOINT_SEED"

_CALLER_ACTIONS = ("drop", "short", "disconnect", "crash")
_ACTIONS = ("raise", "delay", "kill") + _CALLER_ACTIONS


class FailpointError(ConnectionError):
    """Injected failure. Subclasses ``ConnectionError`` on purpose: the
    ``raise`` action targets transport boundaries whose retry/reconnect
    paths are specified to absorb connection errors — an injected raise
    that they DON'T absorb is a real recovery bug, not a test artifact."""


class _Failpoint:
    __slots__ = ("site", "action", "param", "mode", "k", "prob", "rng",
                 "hits", "fires")

    def __init__(self, site: str, trigger: str, action: str,
                 param: Optional[str], seed: int):
        self.site = site
        self.action = action
        self.param = param
        self.hits = 0
        self.fires = 0
        self.k = 1
        self.prob = 0.0
        self.rng: Optional[random.Random] = None
        if trigger == "once":
            self.mode = "once"
        elif trigger.startswith("hit"):
            self.mode = "hit"
            self.k = max(1, int(trigger[3:]))
        elif trigger.startswith("every"):
            self.mode = "every"
            self.k = max(1, int(trigger[5:]))
        elif trigger.startswith("p"):
            self.mode = "p"
            self.prob = min(1.0, max(0.0, float(trigger[1:])))
            # Per-site stream keyed off the global seed: two sites under
            # one seed fire independently yet reproducibly, and a site's
            # schedule is invariant to how often OTHER sites are hit.
            self.rng = random.Random(f"{seed}:{site}")
        else:
            raise ValueError(f"unknown failpoint trigger {trigger!r}")

    def should_fire(self) -> bool:
        self.hits += 1
        if self.mode == "once":
            fire = self.hits == 1
        elif self.mode == "hit":
            fire = self.hits == self.k
        elif self.mode == "every":
            fire = self.hits % self.k == 0
        else:
            fire = self.rng.random() < self.prob
        if fire:
            self.fires += 1
        return fire


_active: Dict[str, _Failpoint] = {}
_journal: List[Tuple[int, int, str, str]] = []
_seq = 0
_seed = 0


def parse_spec(spec: str, seed: int) -> Dict[str, _Failpoint]:
    table: Dict[str, _Failpoint] = {}
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        site, _, rest = part.partition("=")
        bits = rest.split(":")
        if len(bits) < 2:
            raise ValueError(
                f"failpoint spec {part!r} needs site=trigger:action")
        trigger, action = bits[0], bits[1]
        param = bits[2] if len(bits) > 2 else None
        if action not in _ACTIONS:
            raise ValueError(f"unknown failpoint action {action!r} "
                             f"(known: {_ACTIONS})")
        table[site.strip()] = _Failpoint(site.strip(), trigger, action,
                                         param, seed)
    return table


def reload_failpoints() -> None:
    """Rebuild the active table from the env (or the config flag when the
    env var is unset). Cheap when nothing is armed."""
    global _active, _seed
    spec = os.environ.get(ENV_SPEC)
    seed_raw = os.environ.get(ENV_SEED)
    if spec is None or seed_raw is None:
        try:
            from .config import config as _cfg

            c = _cfg()
            if spec is None:
                spec = c.failpoints
            if seed_raw is None:
                seed_raw = str(c.failpoint_seed)
        except Exception:
            spec = spec or ""
            seed_raw = seed_raw or "0"
    try:
        _seed = int(seed_raw or 0)
    except ValueError:
        _seed = 0
    try:
        _active = parse_spec(spec or "", _seed)
    except ValueError:
        logger.exception("malformed failpoint spec %r ignored", spec)
        _active = {}


def set_failpoints(spec: str, seed: int = 0) -> None:
    """Arm failpoints in THIS process and (via env) every process spawned
    after this call. Empty spec disarms — the env var is SET to the
    empty string rather than popped, because an unset var would fall
    back to the ``failpoints`` config flag and silently re-arm whatever
    a ``_system_config`` carried (disarm must mean disarm)."""
    os.environ[ENV_SPEC] = spec
    os.environ[ENV_SEED] = str(seed)
    reload_failpoints()


def clear_failpoints() -> None:
    set_failpoints("")
    reset_journal()


def active() -> bool:
    return bool(_active)


def seed() -> int:
    return _seed


def reset_journal() -> None:
    global _seq
    _journal.clear()
    _seq = 0


def fired_schedule() -> List[Tuple[int, int, str, str]]:
    """The (seq, pid, site, action) journal of every fired point in this
    process. Subprocess fires are journaled in THEIR process; the chaos
    suite reconstructs cross-process order from the seed + spec."""
    return list(_journal)


def format_schedule() -> str:
    if not _journal:
        return f"failpoints: seed={_seed} (none fired in this process)"
    rows = "\n".join(f"  #{seq} pid={pid} {site} -> {action}"
                     for seq, pid, site, action in _journal)
    return (f"failpoints: seed={_seed} spec="
            f"{os.environ.get(ENV_SPEC, '')!r}\n{rows}")


def _journal_fire(site: str, action: str) -> None:
    global _seq
    _seq += 1
    _journal.append((_seq, os.getpid(), site, action))
    logger.warning("failpoint fired: %s -> %s (seed=%d, #%d)",
                   site, action, _seed, _seq)


def fire(site: str, key: Optional[str] = None) -> Optional[str]:
    """Hit a failpoint site. Returns None (by far the common case), or a
    caller-interpreted action string (``drop``/``short``/``disconnect``/
    ``crash``); ``raise`` raises, ``delay`` blocks then returns "delay",
    ``kill`` SIGKILLs this process and never returns."""
    if not _active:
        return None
    fp = None
    if key is not None:
        fp = _active.get(f"{site}.{key}")
    if fp is None:
        fp = _active.get(site)
    if fp is None or not fp.should_fire():
        return None
    action = fp.action
    _journal_fire(fp.site if key is None else f"{fp.site}[{key}]", action)
    if action == "raise":
        raise FailpointError(
            f"failpoint {fp.site!r} injected failure (seed={_seed})")
    if action == "delay":
        # The injected stall IS the fault being simulated — exempt from
        # flow analysis or every fire() caller chain flags.
        time.sleep(float(fp.param or 0.05))  # raylint: disable=RTL101
        return "delay"
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    return action


# Arm from the environment at import (worker/agent processes inherit the
# driver's env), and re-arm whenever the config table is rebuilt so
# ``_system_config={"failpoints": ...}`` lands too.
reload_failpoints()
try:
    from .config import on_config_change

    on_config_change(reload_failpoints)
except Exception:  # pragma: no cover - import cycles during bootstrap
    pass
