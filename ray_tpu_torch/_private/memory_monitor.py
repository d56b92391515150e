"""Host memory monitor + OOM worker-killing policy.

Reference: ``src/ray/common/memory_monitor.h:52`` (kernel memory-usage
polling against a threshold fraction) and the raylet's worker-killing
policies (``raylet/worker_killing_policy_retriable_fifo.h``: prefer
retriable tasks, newest first, so the kill is absorbed by the retry path
instead of failing a job). The node agent runs this loop; a kill is
reported to the GCS as an ``oom_kill`` node event so observability shows
WHY a worker died.

Enabled via the ``memory_monitor_threshold`` flag (fraction of host
memory; 0 disables). Tests override the usage probe with
``RAY_TPU_TORCH_MEMORY_USAGE_PATH`` (a file holding a float fraction).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple


def host_memory_usage_fraction() -> float:
    """Used / total from /proc/meminfo (MemAvailable-based, like the
    reference's kernel probe). Test hook: RAY_TPU_TORCH_MEMORY_USAGE_PATH."""
    override = os.environ.get("RAY_TPU_TORCH_MEMORY_USAGE_PATH")
    if override:
        try:
            with open(override) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return 0.0
    try:
        total = avail = None
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
                if total is not None and avail is not None:
                    break
        if not total or avail is None:
            # No MemAvailable (ancient kernel / restricted procfs): treat
            # as unknown, NOT full — a 1.0 here would kill-loop workers.
            return 0.0
        return 1.0 - avail / total
    except OSError:
        return 0.0


def proc_rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


def pick_victim(candidates: List[Tuple[int, float, bool]]
                ) -> Optional[int]:
    """Retriable-FIFO policy (``worker_killing_policy_retriable_fifo.h``):
    among (pid, task_start_ts, retriable), prefer retriable tasks, and
    among those the NEWEST (least work lost); fall back to newest
    non-retriable only if nothing is retriable.
    """
    if not candidates:
        return None
    retriable = [c for c in candidates if c[2]]
    pool = retriable or candidates
    return max(pool, key=lambda c: c[1])[0]
