"""Directory-based checkpoints + pytree (de)serialization.

Analog of the reference's ``ray.train.Checkpoint``
(``python/ray/train/_checkpoint.py``): a handle to a directory of files.
The pytree helpers save and load the port's trees (parameter dicts and
lists of tensors, ``torch.optim`` state dicts such as AdamW's) with
``torch.save``/``torch.load``; there is no orbax.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Optional


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = tempfile.mkdtemp(prefix="rtpt_ckpt_")
        if os.path.abspath(path) != self.path:
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextmanager
    def as_directory(self):
        yield self.path

    def get_metadata(self) -> Dict[str, Any]:
        meta = os.path.join(self.path, ".metadata.json")
        if os.path.exists(meta):
            with open(meta) as f:
                return json.load(f)
        return {}

    def set_metadata(self, metadata: Dict[str, Any]):
        with open(os.path.join(self.path, ".metadata.json"), "w") as f:
            json.dump(metadata, f)

    def __repr__(self):
        return f"Checkpoint({self.path})"


_STATE = "state.pt"


def save_pytree(tree: Any, path: str) -> int:
    """Save ``tree`` (nested dicts, lists and tuples of tensors and
    scalars, e.g. ``{"params": ..., "opt": opt.state_dict()}``) under
    ``path``; returns the bytes written. Tensors keep their dtype (bf16
    included) and are written from wherever they live; the file appears
    whole or not at all (written aside, then renamed)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, _STATE)
    tmp = target + f".tmp{os.getpid()}"
    import torch

    torch.save(tree, tmp)
    os.replace(tmp, target)
    return os.path.getsize(target)


def load_pytree(path: str, device=None) -> Any:
    """Load what ``save_pytree`` wrote, its tensors onto ``device`` (the
    saving device's, unless given)."""
    import torch

    return torch.load(os.path.join(path, _STATE), map_location=device,
                      weights_only=True)
