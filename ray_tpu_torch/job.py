"""Job submission: run driver scripts on the cluster and track them.

Analog of the reference's job-submission stack
(``python/ray/dashboard/modules/job/``): ``JobSubmissionClient.submit_job``
(``job/sdk.py:35,125``) + the ``JobManager`` supervisor
(``job/job_manager.py``). The manager is a detached named actor on the
cluster; each job's entrypoint runs as a subprocess of that actor's worker
with ``RAY_TPU_TORCH_ADDRESS`` pointing back at the cluster, stdout/stderr
captured to a per-job log file.
"""

from __future__ import annotations

import os
import time
import uuid
from typing import Dict, List, Optional

import ray_tpu_torch

JOB_MANAGER_NAME = "_ray_tpu_job_manager"

# Job states (reference: JobStatus in job/common.py)
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"

TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@ray_tpu_torch.remote
class _JobManager:
    """Detached supervisor actor: one per cluster."""

    def __init__(self):
        import subprocess  # noqa: F401  (imported for workers without site)

        self._jobs: Dict[str, dict] = {}
        self._procs: Dict[str, object] = {}
        from ray_tpu_torch._private.worker import global_worker

        w = global_worker()
        self._session_dir = w.session_dir
        self._gcs_address = w.gcs_address

    def submit(self, job_id: str, entrypoint: str,
               runtime_env: Optional[dict] = None,
               metadata: Optional[dict] = None) -> str:
        import subprocess

        if job_id in self._jobs:
            raise ValueError(f"job {job_id} already exists")
        renv = runtime_env or {}
        env = dict(os.environ)
        env["RAY_TPU_TORCH_ADDRESS"] = self._gcs_address
        from ray_tpu_torch._private.node import worker_sys_path

        env["PYTHONPATH"] = (worker_sys_path() + os.pathsep
                             + env.get("PYTHONPATH", ""))
        env["RAY_TPU_TORCH_JOB_ID"] = job_id
        env.update({k: str(v) for k, v in
                    (renv.get("env_vars") or {}).items()})
        cwd = renv.get("working_dir") or os.getcwd()
        log_path = os.path.join(self._session_dir, f"job-{job_id}.log")
        logf = open(log_path, "ab")
        try:
            proc = subprocess.Popen(
                entrypoint, shell=True, cwd=cwd, env=env,
                stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True)
        except OSError as e:
            self._jobs[job_id] = {
                "job_id": job_id, "entrypoint": entrypoint,
                "status": FAILED, "message": str(e),
                "start_time": time.time(), "end_time": time.time(),
                "metadata": metadata or {}, "log_path": log_path}
            return job_id
        self._procs[job_id] = proc
        self._jobs[job_id] = {
            "job_id": job_id, "entrypoint": entrypoint, "status": RUNNING,
            "message": "", "start_time": time.time(), "end_time": None,
            "metadata": metadata or {}, "log_path": log_path}
        return job_id

    def _refresh(self, job_id: str):
        job = self._jobs.get(job_id)
        proc = self._procs.get(job_id)
        if job is None or proc is None or job["status"] in TERMINAL:
            return
        rc = proc.poll()
        if rc is None:
            return
        job["end_time"] = time.time()
        if job["status"] != STOPPED:
            job["status"] = SUCCEEDED if rc == 0 else FAILED
            job["message"] = f"exit code {rc}"
        self._procs.pop(job_id, None)

    def status(self, job_id: str) -> str:
        self._refresh(job_id)
        job = self._jobs.get(job_id)
        if job is None:
            raise ValueError(f"no such job {job_id}")
        return job["status"]

    def info(self, job_id: str) -> dict:
        self._refresh(job_id)
        job = self._jobs.get(job_id)
        if job is None:
            raise ValueError(f"no such job {job_id}")
        return dict(job)

    def logs(self, job_id: str) -> str:
        job = self._jobs.get(job_id)
        if job is None:
            raise ValueError(f"no such job {job_id}")
        try:
            with open(job["log_path"], "rb") as f:
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def stop(self, job_id: str) -> bool:
        import signal

        self._refresh(job_id)
        job = self._jobs.get(job_id)
        proc = self._procs.get(job_id)
        if job is None:
            raise ValueError(f"no such job {job_id}")
        if job["status"] in TERMINAL:
            return False
        job["status"] = STOPPED
        job["end_time"] = time.time()
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGTERM)
            except (ProcessLookupError, PermissionError):
                proc.terminate()
        return True

    def list(self) -> List[dict]:
        for job_id in list(self._jobs):
            self._refresh(job_id)
        return [dict(j) for j in self._jobs.values()]


class JobSubmissionClient:
    """Reference: ``JobSubmissionClient`` (``dashboard/modules/job/sdk.py``)."""

    def __init__(self, address: Optional[str] = None):
        # In a cluster process (the dashboard's actor) the worker's own
        # connection serves: init() there would start a cluster of its own
        # and run the jobs on it, as the reference's dashboard does.
        from ray_tpu_torch._private import worker as _worker

        if not ray_tpu_torch.is_initialized() and \
                _worker._global_worker is None:
            ray_tpu_torch.init(address=address, ignore_reinit_error=True)
        self._manager = self._get_or_create_manager()

    @staticmethod
    def _get_or_create_manager():
        try:
            return ray_tpu_torch.get_actor(JOB_MANAGER_NAME)
        except ValueError:
            pass
        try:
            return _JobManager.options(
                name=JOB_MANAGER_NAME, lifetime="detached",
                num_cpus=0).remote()
        except ValueError:
            # Raced with another client creating it.
            return ray_tpu_torch.get_actor(JOB_MANAGER_NAME)

    def submit_job(self, *, entrypoint: str,
                   runtime_env: Optional[dict] = None,
                   submission_id: Optional[str] = None,
                   metadata: Optional[dict] = None) -> str:
        job_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        return ray_tpu_torch.get(self._manager.submit.remote(
            job_id, entrypoint, runtime_env, metadata))

    def get_job_status(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._manager.status.remote(job_id))

    def get_job_info(self, job_id: str) -> dict:
        return ray_tpu_torch.get(self._manager.info.remote(job_id))

    def get_job_logs(self, job_id: str) -> str:
        return ray_tpu_torch.get(self._manager.logs.remote(job_id))

    def stop_job(self, job_id: str) -> bool:
        return ray_tpu_torch.get(self._manager.stop.remote(job_id))

    def list_jobs(self) -> List[dict]:
        return ray_tpu_torch.get(self._manager.list.remote())

    def tail_job_logs(self, job_id: str, interval: float = 0.5):
        """Generator yielding new log chunks until the job finishes."""
        offset = 0
        while True:
            text = self.get_job_logs(job_id)
            if len(text) > offset:
                yield text[offset:]
                offset = len(text)
            if self.get_job_status(job_id) in TERMINAL:
                rest = self.get_job_logs(job_id)
                if len(rest) > offset:
                    yield rest[offset:]
                return
            time.sleep(interval)

    def wait_until_finish(self, job_id: str, timeout: float = 300,
                          poll: float = 0.2) -> str:
        deadline = time.time() + timeout
        while time.time() < deadline:
            status = self.get_job_status(job_id)
            if status in TERMINAL:
                return status
            time.sleep(poll)
        raise TimeoutError(f"job {job_id} still {status} after {timeout}s")
