"""Runtime-env plugin API + built-in plugins.

Analog of the reference's ``python/ray/_private/runtime_env/plugin.py``
(``RuntimeEnvPlugin`` ABC with per-field ``validate``/``create``/
``modify_context`` hooks, priority-ordered). Driver side, ``prepare`` turns
local paths into uploaded content-addressed URIs; worker side, ``create``
materializes the URI and folds its effect into the ``RuntimeEnvContext``.
"""

from __future__ import annotations

import glob
import importlib.util
import os
from typing import Any, Callable, Dict, List, Optional

from .context import RuntimeEnvContext
from .packaging import (ensure_local_package, package_directory,
                        package_file)


class RuntimeEnvPlugin:
    """One plugin per runtime_env key."""

    name: str = ""
    priority: int = 10  # lower runs first

    def validate(self, value: Any) -> None:
        """Raise ValueError on a malformed field value."""

    def prepare(self, value: Any, upload: Callable[[str, bytes], None]
                ) -> Any:
        """Driver-side: rewrite the value to a wire-safe form (upload any
        local files via ``upload(uri, data)``). Default: pass through."""
        return value

    def create(self, value: Any, ctx: RuntimeEnvContext,
               fetch: Callable[[str], Optional[bytes]]) -> None:
        """Worker-side: materialize resources and mutate ``ctx``."""


_REGISTRY: Dict[str, RuntimeEnvPlugin] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise ValueError("plugin needs a non-empty name")
    _REGISTRY[plugin.name] = plugin


def unregister_plugin(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_plugins() -> List[RuntimeEnvPlugin]:
    return sorted(_REGISTRY.values(), key=lambda p: (p.priority, p.name))


# ------------------------------------------------------------- built-ins


class EnvVarsPlugin(RuntimeEnvPlugin):
    name = "env_vars"
    priority = 0

    def validate(self, value):
        if not isinstance(value, dict):
            raise ValueError("env_vars must be a dict of str->str")
        for k, v in value.items():
            if not isinstance(k, str) or not isinstance(v, (str, int, float)):
                raise ValueError(f"env_vars entry {k!r}: keys must be str, "
                                 f"values str/number")

    def create(self, value, ctx, fetch):
        ctx.env_vars.update({k: str(v) for k, v in value.items()})
        ctx.taints_worker = True


class WorkingDirPlugin(RuntimeEnvPlugin):
    """Ships a driver-local directory to every worker and chdirs into it.

    Reference: ``runtime_env/working_dir.py`` (upload on submit, download +
    extract per node, cwd + sys.path entry for the task).
    """

    name = "working_dir"
    priority = 1

    def validate(self, value):
        if not isinstance(value, (str, dict)):
            raise ValueError("working_dir must be a path or {'uri': ...}")
        if isinstance(value, str) and value.startswith(("http://", "https://",
                                                        "s3://", "gs://")):
            raise ValueError(
                "remote working_dir URIs are not supported in this "
                "zero-egress build; pass a local directory")

    def prepare(self, value, upload):
        if isinstance(value, dict):  # already prepared
            return value
        excludes = None
        uri, data = package_directory(value, excludes)
        upload(uri, data)
        return {"uri": uri}

    def create(self, value, ctx, fetch):
        path = ensure_local_package(value["uri"], fetch)
        ctx.working_dir = path
        ctx.py_paths.append(path)
        ctx.taints_worker = True


class PyModulesPlugin(RuntimeEnvPlugin):
    """Ships extra importable modules (dirs or wheels) to workers.

    Reference: ``runtime_env/py_modules.py``. Each entry lands on
    ``sys.path``; a directory entry's *parent* semantics follow the
    reference (the directory itself is the importable package, so its
    extracted root is put on the path under the package name).
    """

    name = "py_modules"
    priority = 2

    def validate(self, value):
        if not isinstance(value, (list, tuple)):
            raise ValueError("py_modules must be a list of paths")

    def prepare(self, value, upload):
        out = []
        for item in value:
            if isinstance(item, dict):
                out.append(item)
                continue
            if os.path.isdir(item):
                pkg_name = os.path.basename(os.path.normpath(item))
                uri, data = package_directory(item)
                upload(uri, data)
                out.append({"uri": uri, "module": pkg_name})
            else:
                uri, data = package_file(item)
                upload(uri, data)
                out.append({"uri": uri})
        return out

    def create(self, value, ctx, fetch):
        for item in value:
            path = ensure_local_package(item["uri"], fetch)
            if item.get("module"):
                # Extracted dir IS the package: expose it under its name.
                shim = os.path.join(path + "_parent")
                os.makedirs(shim, exist_ok=True)
                link = os.path.join(shim, item["module"])
                if not os.path.exists(link):
                    try:
                        os.symlink(path, link)
                    except OSError:
                        pass
                ctx.py_paths.append(shim)
            else:
                whls = glob.glob(os.path.join(path, "*.whl"))
                ctx.py_paths.extend(whls or [path])
        ctx.taints_worker = True


class PipPlugin(RuntimeEnvPlugin):
    """pip requirements for a task/actor, satisfied by a DEDICATED worker
    whose interpreter lives in a cached per-spec venv.

    The reference materializes a virtualenv per requirements list via the
    runtime-env agent (``runtime_env/pip.py``); here the node agent builds
    the venv at worker-spawn time (``pip_env.ensure_venv``) and the
    scheduler keeps per-env worker pools, so by the time user code runs
    the interpreter IS the environment — this plugin only sanity-checks
    that routing on the worker side.

    Note: installing from an index needs egress; hermetic setups pass
    local wheel/source paths with ``{"packages": [...], "no_index": True}``.
    """

    name = "pip"
    priority = 3
    tool = "pip"

    def validate(self, value):
        from .pip_env import normalize_spec

        normalize_spec(value, self.tool)

    def prepare(self, value, upload):
        from .pip_env import normalize_spec

        return normalize_spec(value, self.tool)

    def create(self, value, ctx, fetch):
        from .pip_env import env_key, normalize_spec

        spec = normalize_spec(value, self.tool)
        want = env_key(spec)
        have = os.environ.get("RAY_TPU_TORCH_ENV_KEY", "")
        if have != want:
            raise RuntimeError(
                f"task with runtime_env {self.tool} spec (env {want}) was "
                f"dispatched to a worker in env {have or '<base>'} — "
                f"scheduler env-pool routing failed")


class UvPlugin(PipPlugin):
    """uv-built environments (reference: ``runtime_env/uv.py``): same venv
    semantics as pip, built with uv when the binary is present."""

    name = "uv"
    tool = "uv"


class ImageUriPlugin(RuntimeEnvPlugin):
    """Container image for a task/actor's worker (reference:
    ``runtime_env/image_uri.py``). Interpreter-level like pip/uv: the
    scheduler routes to a per-image worker pool and the node agent wraps
    the spawn in ``podman run``/``docker run``
    (``runtime_env/container.py``); this plugin validates the spec and
    sanity-checks the routing on the worker side."""

    name = "image_uri"
    priority = 3

    def validate(self, value):
        from .container import normalize_value

        normalize_value(value)

    def prepare(self, value, upload):
        from .container import normalize_value

        # Wire form is the normalized spec so the scheduler's env key and
        # the worker-side check hash identical inputs.
        return normalize_value(value)

    def create(self, value, ctx, fetch):
        from .container import normalize_value
        from .pip_env import env_key

        want = env_key(normalize_value(value))
        have = os.environ.get("RAY_TPU_TORCH_ENV_KEY", "")
        if have != want:
            raise RuntimeError(
                f"task with image_uri runtime_env (env {want}) was "
                f"dispatched to a worker in env {have or '<base>'} — "
                f"scheduler env-pool routing failed")


class CondaPlugin(RuntimeEnvPlugin):
    """Named conda env activation is not supported in this build (workers
    share one interpreter); fail loudly instead of silently ignoring."""

    name = "conda"
    priority = 3

    def validate(self, value):
        raise ValueError(
            "runtime_env['conda'] is not supported by this build: workers "
            "share the baked cluster image. Use 'pip' (verification mode) "
            "or 'py_modules'/'working_dir' to ship code.")


for _p in (EnvVarsPlugin(), WorkingDirPlugin(), PyModulesPlugin(),
           PipPlugin(), UvPlugin(), ImageUriPlugin(), CondaPlugin()):
    register_plugin(_p)
