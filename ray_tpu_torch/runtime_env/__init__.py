"""Per-task / per-actor runtime environments.

Analog of the reference's ``python/ray/_private/runtime_env/`` subsystem
(working_dir packaging ``working_dir.py``, py_modules ``py_modules.py``,
env-var injection, pip/conda envs, plugin API ``plugin.py``). Re-designed
for this runtime: packages are content-addressed zips stored in the GCS KV
(the reference uploads to its GCS object store the same way), workers
download + extract into a node-local cache, and plugins contribute to a
``RuntimeEnvContext`` that is applied inside the worker process just before
user code runs. There is no per-node runtime-env agent process: workers are
cheap here and a worker that mutates its environment is simply retired
after the task (dedicated-worker semantics).
"""

from .context import RuntimeEnvContext
from .packaging import package_directory, ensure_local_package
from .plugin import (RuntimeEnvPlugin, register_plugin, unregister_plugin,
                     get_plugins)
from .runtime_env import (RuntimeEnv, prepare_runtime_env,
                          setup_runtime_env, validate_runtime_env)

__all__ = [
    "RuntimeEnv",
    "RuntimeEnvContext",
    "RuntimeEnvPlugin",
    "register_plugin",
    "unregister_plugin",
    "get_plugins",
    "package_directory",
    "ensure_local_package",
    "prepare_runtime_env",
    "setup_runtime_env",
    "validate_runtime_env",
]
