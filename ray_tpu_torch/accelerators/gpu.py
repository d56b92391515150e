"""NVIDIA GPU accelerator manager (mixed-cluster parity).

Reference: ``python/ray/_private/accelerators/nvidia_gpu.py`` — detect
GPU count/type via nvidia-smi (or the /proc/driver tree), pin workers
with ``CUDA_VISIBLE_DEVICES``. In the port the GPU is the card the
training and serving paths run on; the node counts its cards in a
subprocess (``node._GPU_PROBE``) and the workers pin themselves here.

Gated: hosts without nvidia-smi report zero GPUs (no hard dependency).
``exec_fn`` is injectable for tests.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Callable, Dict, List, Optional

from .accelerator import AcceleratorManager


class GPUPinConflictError(RuntimeError):
    """A runtime env's ``env_vars`` would point a worker that holds GPUs
    at other cards than its lease pinned it to: the lease wins, and the
    task or actor fails before its first CUDA call."""


class GPUAcceleratorManager(AcceleratorManager):
    resource_name = "GPU"

    _PROBE_TTL_S = 30.0

    def __init__(self, exec_fn: Optional[Callable] = None):
        self._exec = exec_fn
        self._probe_cache: Optional[tuple] = None  # (ts, rows)

    def _probe(self) -> List[str]:
        """One nvidia-smi call answers count AND type; cached briefly so
        a detection cycle doesn't spawn two 10s-timeout subprocesses."""
        import time

        if self._probe_cache is not None and \
                time.monotonic() - self._probe_cache[0] < self._PROBE_TTL_S:
            return self._probe_cache[1]
        binary = shutil.which("nvidia-smi")
        rows: List[str] = []
        if self._exec is not None or binary is not None:
            argv = [binary or "nvidia-smi",
                    "--query-gpu=index,name",
                    "--format=csv,noheader"]
            try:
                if self._exec is not None:
                    out = self._exec(argv)
                else:
                    out = subprocess.run(argv, capture_output=True,
                                         text=True, timeout=10).stdout
                rows = [l.strip() for l in out.splitlines() if l.strip()]
            except Exception:
                rows = []
        self._probe_cache = (time.monotonic(), rows)
        return rows

    def get_current_node_num_accelerators(self) -> int:
        return len(self._probe())

    def get_current_node_accelerator_type(self) -> Optional[str]:
        rows = self._probe()
        if not rows:
            return None
        # "0, NVIDIA H100 80GB HBM3" -> "H100" (the reference normalizes
        # to the accelerator_type constants the scheduler matches on)
        name = rows[0].partition(",")[2].replace("NVIDIA", "").split()
        return name[0] if name else None

    def get_current_node_extra_resources(self) -> Dict[str, float]:
        t = self.get_current_node_accelerator_type()
        return {f"accelerator_type:{t}": 1.0} if t else {}

    def get_visible_accelerator_ids_env_var(self) -> str:
        return "CUDA_VISIBLE_DEVICES"

    def set_visible_accelerators(self, env: Dict[str, str],
                                 ids: List[str]) -> None:
        """Pin ``env`` to the node's cards ``ids`` (indices "0".."n-1").
        Where the node itself was started with ``CUDA_VISIBLE_DEVICES``,
        the indices name entries of that list, as the reference maps
        assigned ids onto the visible set."""
        var = self.get_visible_accelerator_ids_env_var()
        base = [v for v in env.get(var, "").split(",") if v != ""]
        if base:
            ids = [base[int(i)] for i in ids]
        env[var] = ",".join(ids)


class NeuronAcceleratorManager(AcceleratorManager):
    """AWS Neuron (Trainium/Inferentia) — reference:
    ``_private/accelerators/neuron.py``: device count from
    /proc/devices + neuron-ls, pinning via NEURON_RT_VISIBLE_CORES."""

    resource_name = "neuron_cores"

    def __init__(self, exec_fn: Optional[Callable] = None):
        self._exec = exec_fn

    def get_current_node_num_accelerators(self) -> int:
        binary = shutil.which("neuron-ls")
        if self._exec is None and binary is None:
            return 0
        argv = [binary or "neuron-ls", "--json-output"]
        try:
            if self._exec is not None:
                out = self._exec(argv)
            else:
                out = subprocess.run(argv, capture_output=True, text=True,
                                     timeout=10).stdout
            import json

            return sum(int(d.get("nc_count", 0)) for d in json.loads(out))
        except Exception:
            return 0

    def get_current_node_accelerator_type(self) -> Optional[str]:
        return "aws-neuron" if \
            self.get_current_node_num_accelerators() else None

    def get_visible_accelerator_ids_env_var(self) -> str:
        return "NEURON_RT_VISIBLE_CORES"
