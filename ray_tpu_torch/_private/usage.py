"""Local usage/cluster-metadata recording.

Reference: ``python/ray/_private/usage/usage_lib.py:171`` — collects
cluster metadata and which libraries a session used. This build is
zero-egress: everything stays LOCAL (``usage.json`` in the session dir +
the ``/api/usage`` endpoint); nothing ever phones home.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import threading
import time
from typing import Dict, Set

_lock = threading.Lock()
_libraries: Set[str] = set()
_features: Dict[str, int] = {}


def record_library_usage(name: str):
    """Called by library entry points (data/train/tune/serve/rl...)."""
    with _lock:
        _libraries.add(name)


def record_feature(name: str):
    """Count a feature use (e.g. 'placement_group', 'runtime_env.pip')."""
    with _lock:
        _features[name] = _features.get(name, 0) + 1


def usage_report() -> dict:
    import ray_tpu_torch

    with _lock:
        libs = sorted(_libraries)
        feats = dict(_features)
    report = {
        "ray_tpu_version": ray_tpu_torch.__version__,
        "python_version": platform.python_version(),
        "os": platform.system().lower(),
        "arch": platform.machine(),
        "cpu_count": os.cpu_count(),
        "libraries_used": libs,
        "features": feats,
        "collected_at": time.time(),
    }
    try:
        import torch

        report["torch_version"] = torch.__version__
    except Exception:
        pass
    try:
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        report["session_name"] = w.session_name
        info = w.cluster_info()
        report["num_nodes"] = len(info.get("nodes", []))
    except Exception:
        pass
    return report


def write_usage_file() -> str:
    """Persist the report to the session dir (local only)."""
    from ray_tpu_torch._private.worker import global_worker

    path = os.path.join(global_worker().session_dir, "usage.json")
    with open(path, "w") as f:
        json.dump(usage_report(), f, indent=2, default=str)
    return path
