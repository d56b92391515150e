"""Container (image_uri) runtime env: workers inside podman/docker.

Reference: ``python/ray/_private/runtime_env/image_uri.py`` — a task/actor
with ``runtime_env={"image_uri": ...}`` runs in a DEDICATED worker whose
process lives inside the requested container image. Same shape here: the
scheduler routes such tasks to a per-image worker pool (the pip/uv env-
pool machinery, ``pip_env.spawn_spec_from_renv``), and the node agent
wraps the worker command in ``podman run``/``docker run`` with the
session directory, shm segments, and framework source bind-mounted at
identical paths so sockets and zero-copy objects work unchanged.

Gated: hosts without a container runtime raise a clear error at spawn;
``RAY_TPU_TORCH_CONTAINER_RUNTIME`` overrides binary discovery (tests point it
at a fake runtime).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple


def normalize_value(value: Any) -> Dict[str, Any]:
    """Accept ``"image:tag"`` or ``{"image_uri": ..., "run_options": [...],
    "python": ...}``; returns the normalized spec."""
    if isinstance(value, str):
        spec: Dict[str, Any] = {"image_uri": value}
    elif isinstance(value, dict):
        spec = dict(value)
    else:
        raise ValueError("image_uri must be an image string or a dict "
                         "with 'image_uri'")
    if not spec.get("image_uri") or not isinstance(spec["image_uri"], str):
        raise ValueError("image_uri requires a non-empty image string")
    ro = spec.get("run_options", [])
    if not isinstance(ro, (list, tuple)) or \
            not all(isinstance(o, str) for o in ro):
        raise ValueError("run_options must be a list of strings")
    spec["run_options"] = list(ro)
    spec["tool"] = "container"
    return spec


def runtime_binary() -> Optional[str]:
    override = os.environ.get("RAY_TPU_TORCH_CONTAINER_RUNTIME")
    if override:
        return override if os.path.exists(override) else \
            shutil.which(override)
    for name in ("podman", "docker"):
        path = shutil.which(name)
        if path:
            return path
    return None


def wrap_spawn(spec: Dict[str, Any], argv: List[str],
               env: Dict[str, str], session_dir: str,
               sys_paths: str) -> Tuple[List[str], Dict[str, str]]:
    """Wrap a worker spawn command in ``<runtime> run``.

    Bind-mounts keep ABSOLUTE PATHS IDENTICAL inside the container:
    the session dir (UDS sockets, logs), /dev/shm (arena segments — the
    zero-copy object path crosses the container boundary through the
    same shared memory), /tmp/ray_tpu_torch (venv/package caches), and every
    sys.path entry the worker needs (framework source). Host networking
    so the GCS TCP/UDS addresses resolve unchanged.
    """
    binary = runtime_binary()
    if binary is None:
        raise RuntimeError(
            "runtime_env['image_uri'] requires podman or docker on the "
            "worker host (or RAY_TPU_TORCH_CONTAINER_RUNTIME pointing at one); "
            "neither was found")
    cache_dir = os.path.join(os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch")
    os.makedirs(cache_dir, exist_ok=True)  # podman refuses missing sources
    mounts = {session_dir, "/dev/shm", cache_dir}
    for p in sys_paths.split(os.pathsep):
        if p and os.path.exists(p):
            mounts.add(p)
    cmd = [binary, "run", "--rm", "--network=host", "--ipc=host"]
    for m in sorted(mounts):
        cmd += ["-v", f"{m}:{m}"]
    # Allowlisted env forwarding: wholesale os.environ would clobber
    # image-critical vars (PATH, PYTHONHOME, LD_LIBRARY_PATH...) with
    # host values whose paths don't exist inside the image.
    fwd_prefixes = ("RAY_TPU_TORCH_", "CUDA_", "NVIDIA_", "TORCH_")
    for k, v in sorted(env.items()):
        if k.startswith(fwd_prefixes) or k in ("TMPDIR",):
            cmd += ["-e", f"{k}={v}"]
    cmd += spec.get("run_options", [])
    cmd.append(spec["image_uri"])
    inner = list(argv)
    # sys.executable's path rarely exists inside the image; run the
    # image's interpreter instead (override via spec["python"]).
    inner[0] = spec.get("python", "python3")
    return cmd + inner, dict(env)
