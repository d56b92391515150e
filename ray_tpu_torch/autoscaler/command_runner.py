"""Command runners: how the cluster launcher reaches provisioned nodes.

Reference: ``python/ray/autoscaler/_private/command_runner.py``
(``SSHCommandRunner``): a GPU host is one VM, so one runner reaches one
node. Subprocess-based ssh/scp; a ``LocalCommandRunner`` runs on this host
so launcher logic is testable without SSH, and every runner takes an
injectable ``exec_fn`` so tests can record instead of execute.
"""

from __future__ import annotations

import subprocess
from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Sequence


class CommandRunner(ABC):
    @abstractmethod
    def run(self, cmd: str, *, timeout: Optional[float] = None) -> str:
        """Run a shell command on the node; returns stdout."""

    @abstractmethod
    def run_rsync_up(self, source: str, target: str):
        """Copy a local file/dir to the node."""


def _default_exec(argv: Sequence[str], timeout: Optional[float]) -> str:
    out = subprocess.run(list(argv), capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(
            f"command {argv[0]} failed (rc={out.returncode}): "
            f"{out.stderr.strip()[:500]}")
    return out.stdout


class LocalCommandRunner(CommandRunner):
    """Runs commands on this host (fake-multinode / test path)."""

    def __init__(self, exec_fn: Optional[Callable] = None):
        self._exec = exec_fn or _default_exec

    def run(self, cmd: str, *, timeout: Optional[float] = None) -> str:
        return self._exec(["bash", "-lc", cmd], timeout)

    def run_rsync_up(self, source: str, target: str):
        self._exec(["cp", "-r", source, target], None)


class SSHCommandRunner(CommandRunner):
    """Plain ssh/scp against one address (reference SSHCommandRunner)."""

    def __init__(self, address: str, *, ssh_user: str = "ray",
                 ssh_key: Optional[str] = None,
                 exec_fn: Optional[Callable] = None):
        self.address = address
        self.ssh_user = ssh_user
        self.ssh_key = ssh_key
        self._exec = exec_fn or _default_exec

    def _ssh_base(self) -> List[str]:
        base = ["ssh", "-o", "StrictHostKeyChecking=no",
                "-o", "ConnectTimeout=10"]
        if self.ssh_key:
            base += ["-i", self.ssh_key]
        return base

    def run(self, cmd: str, *, timeout: Optional[float] = None) -> str:
        argv = self._ssh_base() + [f"{self.ssh_user}@{self.address}", cmd]
        return self._exec(argv, timeout)

    def run_rsync_up(self, source: str, target: str):
        argv = ["scp", "-o", "StrictHostKeyChecking=no", "-r"]
        if self.ssh_key:
            argv += ["-i", self.ssh_key]
        argv += [source, f"{self.ssh_user}@{self.address}:{target}"]
        self._exec(argv, None)
