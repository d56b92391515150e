"""Experiment callbacks + logger callbacks (JSON / CSV / TensorBoard).

Reference: ``python/ray/tune/callback.py`` (the ``Callback`` interface the
TuneController drives) and ``python/ray/tune/logger/{json,csv,tensorboardx}
.py`` (the default per-trial result loggers). The Tune loop invokes every
callback in ``RunConfig.callbacks``; the three logger callbacks here are
also what ``Tuner`` installs by default so every experiment directory is
inspectable with standard tools.

``TBXLoggerCallback`` needs no tensorboard/tensorboardX package: a
TensorBoard event file is TFRecord-framed ``Event`` protobufs, and both the
TFRecord framing and the protobuf wire helpers already live in
``ray_tpu_torch.data.tfrecords`` — the scalar-event encoder here is ~40 lines on
top of them, and the result is readable by any stock TensorBoard.
"""

from __future__ import annotations

import csv
import json
import os
import socket
import struct
import time
from typing import Any, Dict, List, Optional

from ..data.tfrecords import _write_varint, frame_tfrecord


class Callback:
    """Experiment-loop hooks (reference: ``ray.tune.Callback``).

    All methods are optional; the Tune loop calls them with the internal
    ``Trial`` object (``trial.id``, ``trial.config``, ``trial.logdir``,
    ``trial.last_result``).
    """

    def setup(self, experiment_path: str):
        pass

    def on_trial_start(self, trial):
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]):
        pass

    def on_trial_complete(self, trial):
        pass

    def on_trial_error(self, trial):
        pass

    def on_experiment_end(self, trials: List[Any]):
        pass


class LoggerCallback(Callback):
    """Per-trial logging base: tracks trial log dirs, fans the generic
    callback hooks into ``log_trial_{start,result,end}`` (reference:
    ``tune/logger/logger.py:LoggerCallback``)."""

    def on_trial_start(self, trial):
        os.makedirs(trial.logdir, exist_ok=True)
        self.log_trial_start(trial)

    def on_trial_result(self, trial, result):
        self.log_trial_result(trial, result)

    def on_trial_complete(self, trial):
        self.log_trial_end(trial, failed=False)

    def on_trial_error(self, trial):
        self.log_trial_end(trial, failed=True)

    def log_trial_start(self, trial):
        pass

    def log_trial_result(self, trial, result):
        pass

    def log_trial_end(self, trial, failed: bool):
        pass


def _json_safe(v):
    try:
        json.dumps(v)
        return v
    except (TypeError, ValueError):
        return repr(v)


class JsonLoggerCallback(LoggerCallback):
    """``result.json``: one JSON line per reported result, plus
    ``params.json`` with the trial config (reference:
    ``tune/logger/json.py``)."""

    def log_trial_start(self, trial):
        with open(os.path.join(trial.logdir, "params.json"), "w") as f:
            json.dump({k: _json_safe(v) for k, v in trial.config.items()},
                      f)

    def log_trial_result(self, trial, result):
        with open(os.path.join(trial.logdir, "result.json"), "a") as f:
            json.dump({k: _json_safe(v) for k, v in result.items()}, f)
            f.write("\n")


class CSVLoggerCallback(LoggerCallback):
    """``progress.csv`` per trial. The header is fixed at the first result
    (reference: ``tune/logger/csv.py`` — fields appearing later are
    dropped, fields missing later are left empty)."""

    def __init__(self):
        self._writers: Dict[str, Any] = {}
        self._files: Dict[str, Any] = {}

    def log_trial_result(self, trial, result):
        if trial.id not in self._writers:
            path = os.path.join(trial.logdir, "progress.csv")
            # Append: a resumed trial (Tuner.restore) must extend its
            # pre-interrupt history, not truncate it.
            fresh = not os.path.exists(path) or os.path.getsize(path) == 0
            fields = list(result.keys())
            if not fresh:
                with open(path, newline="") as existing:
                    header = existing.readline().strip()
                fields = header.split(",") if header else fields
            f = open(path, "a", newline="")
            w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
            if fresh:
                w.writeheader()
            self._files[trial.id], self._writers[trial.id] = f, w
        self._writers[trial.id].writerow(
            {k: _json_safe(v) for k, v in result.items()})
        self._files[trial.id].flush()

    def log_trial_end(self, trial, failed):
        f = self._files.pop(trial.id, None)
        self._writers.pop(trial.id, None)
        if f is not None:
            f.close()


# ----------------------------------------------- TensorBoard event files


def _pb_len_delim(field: int, payload: bytes) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | 2)
    _write_varint(out, len(payload))
    return bytes(out) + payload


def _pb_varint(field: int, v: int) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | 0)
    _write_varint(out, v & ((1 << 64) - 1))
    return bytes(out)


def _pb_double(field: int, v: float) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | 1)
    return bytes(out) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    out = bytearray()
    _write_varint(out, (field << 3) | 5)
    return bytes(out) + struct.pack("<f", v)


def encode_scalar_event(wall_time: float, step: int,
                        scalars: Dict[str, float]) -> bytes:
    """``Event{wall_time=1, step=2, summary=5}`` with one
    ``Summary.Value{tag=1, simple_value=2}`` per scalar."""
    summary = b"".join(
        _pb_len_delim(1, _pb_len_delim(1, tag.encode()) + _pb_float(2, v))
        for tag, v in scalars.items())
    return (_pb_double(1, wall_time) + _pb_varint(2, step)
            + _pb_len_delim(5, summary))


def encode_file_version_event(wall_time: float) -> bytes:
    """The mandatory first record: ``Event{file_version="brain.Event:2"}``
    (field 3)."""
    return _pb_double(1, wall_time) + _pb_len_delim(3, b"brain.Event:2")


class TBXLoggerCallback(LoggerCallback):
    """TensorBoard scalar logging with no tensorboard dependency
    (reference: ``tune/logger/tensorboardx.py``). Writes
    ``events.out.tfevents.<ts>.<host>`` per trial; numeric result fields
    become scalar summaries keyed ``ray/tune/<field>`` (the reference's
    tag convention), stepped by ``training_iteration`` when present."""

    def __init__(self):
        self._files: Dict[str, Any] = {}
        self._steps: Dict[str, int] = {}

    def log_trial_start(self, trial):
        path = os.path.join(
            trial.logdir,
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}")
        f = open(path, "ab")
        f.write(frame_tfrecord(encode_file_version_event(time.time())))
        self._files[trial.id] = f

    def log_trial_result(self, trial, result):
        f = self._files.get(trial.id)
        if f is None:
            return
        scalars = {f"ray/tune/{k}": float(v) for k, v in result.items()
                   if isinstance(v, (int, float))
                   and not isinstance(v, bool)}
        if not scalars:
            return
        step = result.get("training_iteration")
        if step is None:
            step = self._steps[trial.id] = self._steps.get(trial.id, 0) + 1
        f.write(frame_tfrecord(
            encode_scalar_event(time.time(), int(step), scalars)))
        f.flush()

    def log_trial_end(self, trial, failed):
        f = self._files.pop(trial.id, None)
        self._steps.pop(trial.id, None)
        if f is not None:
            f.close()


def decode_scalar_events(path: str) -> List[Dict[str, Any]]:
    """Parse an event file back to ``[{"step": n, "wall_time": t,
    "scalars": {tag: value}}, ...]`` — the verification half of the
    dependency-free writer (used by tests and ``ray_tpu_torch.tune`` result
    inspection)."""
    from ..data.tfrecords import _fields, read_tfrecord_frames

    out = []
    for payload in read_tfrecord_frames(path, verify=True):
        ev: Dict[str, Any] = {"step": 0, "wall_time": 0.0, "scalars": {}}
        for field, wt, val in _fields(memoryview(payload)):
            if field == 1 and wt == 1:
                ev["wall_time"] = struct.unpack("<d", val)[0]
            elif field == 2 and wt == 0:
                ev["step"] = val
            elif field == 5 and wt == 2:
                for vfield, _vwt, vmsg in _fields(val):
                    if vfield != 1:
                        continue
                    tag, value = None, None
                    for sfield, swt, sval in _fields(vmsg):
                        if sfield == 1 and swt == 2:
                            tag = bytes(sval).decode()
                        elif sfield == 2 and swt == 5:
                            value = struct.unpack("<f", sval)[0]
                    if tag is not None and value is not None:
                        ev["scalars"][tag] = value
            elif field == 3 and wt == 2:
                ev["file_version"] = bytes(val).decode()
        out.append(ev)
    return out
