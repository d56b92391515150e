"""Public interface types: sinks, compute strategies, execution options.

Reference: ``python/ray/data/datasource/datasink.py`` (Datasink +
file-datasink bases), ``data/_internal/compute.py`` (ActorPoolStrategy),
``data/_internal/execution/interfaces/execution_options.py``
(ExecutionOptions / ExecutionResources), ``data/datasource/datasource.py``
(ReadTask).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from .block import BlockAccessor, to_block

# Node ids travel as hex strings through the public API.
NodeIdStr = str


class Datasink:
    """Custom write connector (reference: ``ray.data.Datasink``):
    ``Dataset.write_datasink`` streams every output block through
    ``write(block, block_index)`` between the start/complete hooks."""

    def on_write_start(self) -> None:
        pass

    def write(self, block, block_index: int) -> None:
        raise NotImplementedError

    def on_write_complete(self) -> None:
        pass


class BlockBasedFileDatasink(Datasink):
    """One output file per block (reference:
    ``ray.data.BlockBasedFileDatasink``): subclass
    ``write_block_to_file(block, file)``."""

    def __init__(self, path: str, *, file_format: str = "bin"):
        self.path = path
        self.file_format = file_format

    def on_write_start(self) -> None:
        os.makedirs(self.path, exist_ok=True)

    def write(self, block, block_index: int) -> None:
        name = f"part-{block_index:05d}.{self.file_format}"
        with open(os.path.join(self.path, name), "wb") as f:
            self.write_block_to_file(to_block(block), f)

    def write_block_to_file(self, block, file) -> None:
        raise NotImplementedError


class RowBasedFileDatasink(Datasink):
    """One output file per ROW (reference:
    ``ray.data.RowBasedFileDatasink``): subclass
    ``write_row_to_file(row, file)``."""

    def __init__(self, path: str, *, file_format: str = "bin"):
        self.path = path
        self.file_format = file_format
        self._row = 0

    def on_write_start(self) -> None:
        os.makedirs(self.path, exist_ok=True)

    def write(self, block, block_index: int) -> None:
        for row in BlockAccessor(to_block(block)).rows():
            name = f"{self._row:06d}.{self.file_format}"
            with open(os.path.join(self.path, name), "wb") as f:
                self.write_row_to_file(dict(row), f)
            self._row += 1

    def write_row_to_file(self, row: dict, file) -> None:
        raise NotImplementedError


@dataclass
class ActorPoolStrategy:
    """``map_batches(..., compute=ActorPoolStrategy(...))`` — the
    actor-pool compute strategy object (reference:
    ``ray.data.ActorPoolStrategy``). ``size`` pins a fixed pool;
    otherwise the op's pool AUTOSCALES between ``min_size`` and
    ``max_size`` against its own queue depth (sustained head-of-line
    congestion grows it, idle workers shrink it back — see
    ``Dataset._stream_pool_segment``). ``max_size=None`` resolves
    against the per-op budget from
    ``ExecutionOptions.resource_limits.cpu``, else cluster CPUs."""

    size: Optional[int] = None
    min_size: int = 1
    max_size: Optional[int] = None

    def pool_size(self) -> int:
        if self.size is not None:
            return max(1, int(self.size))
        return max(1, int(self.min_size))


@dataclass
class ExecutionResources:
    """Resource ceiling for a dataset execution (reference:
    ``ray.data.ExecutionResources``)."""

    cpu: Optional[float] = None
    gpu: Optional[float] = None
    object_store_memory: Optional[float] = None


@dataclass
class ExecutionOptions:
    """Executor knobs (reference: ``ray.data.ExecutionOptions``).
    ``resource_limits.object_store_memory`` feeds the memory-budget
    backpressure policy; ``locality_with_output`` toggles
    locality-aware scheduling (both consumed via DataContext)."""

    resource_limits: ExecutionResources = field(
        default_factory=ExecutionResources)
    locality_with_output: bool = False
    preserve_order: bool = True
    verbose_progress: bool = False


@dataclass
class ReadTask:
    """One unit of a Datasource read: a thunk producing blocks plus its
    metadata estimate (reference: ``ray.data.ReadTask``)."""

    read_fn: Callable[[], Any]
    metadata: Optional[dict] = None

    def __call__(self):
        return self.read_fn()
