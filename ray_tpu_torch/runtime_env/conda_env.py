"""Conda runtime environments.

Analog of the reference's conda runtime-env plugin
(``python/ray/_private/runtime_env/conda.py``): a task or actor declaring
``runtime_env={"conda": ...}`` runs in a dedicated worker whose interpreter
comes from a conda environment. Two forms, matching the reference:

  * ``{"conda": "env-name"}`` — an EXISTING named conda env; its python
    is used directly (nothing is built).
  * ``{"conda": {"dependencies": [...]}}`` — an environment dict; built
    once into a content-addressed cache dir via ``conda env create`` and
    reused by every later worker with the same spec.

Gated on the ``conda`` binary (``micromamba``/``mamba`` accepted as
drop-ins); hosts without one raise a clear error at spawn time.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
from typing import Any, Dict, Optional

from .pip_env import venv_root


def _conda_bin() -> Optional[str]:
    for name in ("conda", "micromamba", "mamba"):
        path = shutil.which(name)
        if path:
            return path
    return None


def normalize_conda(value: Any) -> Dict[str, Any]:
    if isinstance(value, str):
        return {"tool": "conda", "name": value}
    if isinstance(value, dict):
        return {"tool": "conda", "env": value}
    raise ValueError(
        "conda runtime_env must be an env name (str) or an environment "
        "dict with 'dependencies'")


def conda_key(spec: Dict[str, Any]) -> str:
    blob = json.dumps(spec, sort_keys=True).encode()
    return "conda-" + hashlib.sha1(blob).hexdigest()[:16]


def _env_python(prefix: str) -> str:
    return os.path.join(prefix, "bin", "python")


def _site_packages(prefix: str, python: str) -> str:
    out = subprocess.run(
        [python, "-c",
         "import sysconfig; print(sysconfig.get_paths()['purelib'])"],
        capture_output=True, text=True, timeout=60)
    if out.returncode == 0 and out.stdout.strip():
        return out.stdout.strip()
    major_minor = f"python{sys.version_info[0]}.{sys.version_info[1]}"
    return os.path.join(prefix, "lib", major_minor, "site-packages")


def _named_env_prefix(conda: str, name: str) -> str:
    out = subprocess.run([conda, "env", "list", "--json"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode == 0:
        try:
            for prefix in json.loads(out.stdout).get("envs", []):
                if os.path.basename(prefix) == name:
                    return prefix
        except json.JSONDecodeError:
            pass
    raise ValueError(f"conda env {name!r} not found on this host")


def ensure_conda_env(spec: Dict[str, Any],
                     timeout: float = 1800.0) -> Dict[str, str]:
    """Resolve (named) or build (dict) the env; returns
    {"python", "site", "key"} like ``pip_env.ensure_venv``."""
    conda = _conda_bin()
    if conda is None:
        raise RuntimeError(
            "runtime_env={'conda': ...} requires a conda/micromamba binary "
            "on the host; none found on PATH")
    if "name" in spec:
        prefix = _named_env_prefix(conda, spec["name"])
        python = _env_python(prefix)
        return {"python": python, "site": _site_packages(prefix, python),
                "key": conda_key(spec)}

    key = conda_key(spec)
    root = venv_root()
    os.makedirs(root, exist_ok=True)
    prefix = os.path.join(root, key)
    ok_marker = os.path.join(prefix, ".ray_tpu_ok")
    log_path = os.path.join(root, f"{key}.log")
    python = _env_python(prefix)
    if not os.path.exists(ok_marker):
        env_yaml = os.path.join(root, f"{key}.yml")
        with open(env_yaml, "w") as f:
            json.dump(spec["env"], f)  # YAML is a JSON superset
        with open(log_path, "ab") as log:
            subprocess.run(
                [conda, "env", "create", "--prefix", prefix, "--file",
                 env_yaml, "--yes"] if "micromamba" not in conda else
                [conda, "create", "--prefix", prefix, "--file", env_yaml,
                 "--yes"],
                check=True, stdout=log, stderr=subprocess.STDOUT,
                timeout=timeout)
        with open(ok_marker, "w"):
            pass
    return {"python": python, "site": _site_packages(prefix, python),
            "key": key}
