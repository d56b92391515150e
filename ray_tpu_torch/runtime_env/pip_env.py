"""Per-environment Python venv construction for runtime_env pip/uv.

Analog of the reference's pip/uv runtime-env plugins
(``python/ray/_private/runtime_env/pip.py``, ``uv.py``): a task or actor
declaring ``runtime_env={"pip": [...]}`` runs in a DEDICATED worker whose
interpreter lives in a cached venv containing those packages. Unlike the
reference (which delegates to a per-node runtime-env agent HTTP service),
the node agent builds the venv inline at worker-spawn time — same cache
semantics, one fewer daemon.

Key properties:
  * Content-addressed cache: one venv per normalized spec hash, shared by
    every worker/session on the host (reference: URI-cached envs).
  * Concurrent-safe: builders race on an atomic marker; losers wait.
  * The parent environment's packages stay importable (the venv's site
    dir is prepended to the worker's path, parent paths follow), so the
    framework, torch and the built kernels remain available while
    requested packages override.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional


def normalize_spec(value: Any, tool: str) -> Dict[str, Any]:
    """Accept ``[pkgs...]`` or ``{"packages": [...], ...}``; normalized."""
    if isinstance(value, (list, tuple)):
        spec = {"packages": list(value)}
    elif isinstance(value, dict):
        spec = dict(value)
        spec["packages"] = list(spec.get("packages", []))
    else:
        raise ValueError(f"{tool} runtime_env must be a list of requirement "
                         f"strings or a dict with 'packages'")
    for p in spec["packages"]:
        if not isinstance(p, str):
            raise ValueError(f"{tool} package entries must be strings, "
                             f"got {type(p).__name__}")
    spec["tool"] = tool
    return spec


def env_key(spec: Dict[str, Any]) -> str:
    """Stable identity of the interpreter environment a spec produces."""
    blob = json.dumps(spec, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def venv_root() -> str:
    return os.environ.get(
        "RAY_TPU_TORCH_VENV_ROOT",
        os.path.join(os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch", "venvs"))


def _site_packages(venv_dir: str) -> str:
    major_minor = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    return os.path.join(venv_dir, "lib", major_minor, "site-packages")


def _build(venv_dir: str, spec: Dict[str, Any], log_path: str) -> None:
    tool = spec.get("tool", "pip")
    uv = shutil.which("uv") if tool == "uv" else None
    with open(log_path, "ab") as log:
        if uv:
            subprocess.run([uv, "venv", "--python", sys.executable,
                            venv_dir], check=True, stdout=log,
                           stderr=subprocess.STDOUT)
        else:
            subprocess.run([sys.executable, "-m", "venv", venv_dir],
                           check=True, stdout=log, stderr=subprocess.STDOUT)
        pkgs = spec.get("packages", [])
        if pkgs:
            if uv:
                cmd = [uv, "pip", "install", "--python",
                       os.path.join(venv_dir, "bin", "python")]
            else:
                cmd = [os.path.join(venv_dir, "bin", "python"), "-m",
                       "pip", "install", "--no-input"]
            if spec.get("no_index"):
                cmd.append("--no-index")
            if spec.get("no_deps"):
                cmd.append("--no-deps")
            for opt in spec.get("install_options", []):
                cmd.append(str(opt))
            cmd.extend(pkgs)
            subprocess.run(cmd, check=True, stdout=log,
                           stderr=subprocess.STDOUT)


def ensure_venv(spec: Dict[str, Any],
                timeout: float = 600.0) -> Dict[str, str]:
    """Build (or reuse) the venv for ``spec``.

    Returns {"python": ..., "site": ..., "key": ...}. Raises on build
    failure with the tail of the build log attached.
    """
    key = env_key(spec)
    root = venv_root()
    os.makedirs(root, exist_ok=True)
    venv_dir = os.path.join(root, key)
    ok_marker = os.path.join(venv_dir, ".ray_tpu_ok")
    log_path = os.path.join(root, f"{key}.log")
    result = {"python": os.path.join(venv_dir, "bin", "python"),
              "site": _site_packages(venv_dir), "key": key}
    if os.path.exists(ok_marker):
        return result
    build_dir = venv_dir + ".building"
    try:
        os.mkdir(build_dir)  # atomic claim
        claimed = True
    except FileExistsError:
        claimed = False
    if claimed:
        try:
            shutil.rmtree(venv_dir, ignore_errors=True)
            _build(venv_dir, spec, log_path)
            with open(ok_marker, "w") as f:
                f.write(json.dumps(spec))
        except subprocess.CalledProcessError as e:
            tail = ""
            try:
                with open(log_path, "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
            except OSError:
                pass
            raise RuntimeError(
                f"runtime_env {spec.get('tool')} env build failed "
                f"(rc={e.returncode}):\n{tail}") from e
        finally:
            shutil.rmtree(build_dir, ignore_errors=True)
        return result
    # Another builder claimed it: wait for the marker.
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(ok_marker):
            return result
        if not os.path.exists(build_dir):
            # Builder died without finishing: take over.
            return ensure_venv(spec, timeout=max(1.0, deadline - time.time()))
        time.sleep(0.2)
    raise TimeoutError(f"timed out waiting for venv {key} build")


def spawn_spec_from_renv(renv: Optional[Dict[str, Any]]
                         ) -> Optional[Dict[str, Any]]:
    """Extract the interpreter-level part of a wire runtime_env (the part
    that must be satisfied at worker SPAWN, not in-process)."""
    if not renv:
        return None
    if renv.get("image_uri") is not None:
        from .container import normalize_value

        return normalize_value(renv["image_uri"])
    if renv.get("conda") is not None:
        from .conda_env import normalize_conda

        return normalize_conda(renv["conda"])
    if renv.get("uv") is not None:
        return normalize_spec(renv["uv"], "uv")
    if renv.get("pip") is not None:
        return normalize_spec(renv["pip"], "pip")
    return None

