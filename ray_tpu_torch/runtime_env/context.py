"""Worker-side runtime-env context.

Analog of the reference's ``RuntimeEnvContext``
(``python/ray/_private/runtime_env/context.py``): the accumulated effect of
every plugin — env vars to export, paths to prepend to ``sys.path``, a
working directory to enter — applied in the worker process right before
user code executes.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class RuntimeEnvContext:
    env_vars: Dict[str, str] = field(default_factory=dict)
    py_paths: List[str] = field(default_factory=list)
    working_dir: Optional[str] = None
    # True if applying this context taints the worker for other tasks
    # (env mutations, chdir): the worker is retired after the task.
    taints_worker: bool = False

    def apply(self) -> None:
        if self.env_vars:
            os.environ.update(
                {k: str(v) for k, v in self.env_vars.items()})
        for p in reversed(self.py_paths):
            if p not in sys.path:
                sys.path.insert(0, p)
        if self.working_dir:
            os.chdir(self.working_dir)
