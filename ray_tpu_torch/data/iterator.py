"""DataIterator: the per-consumer batch stream.

Reference: ``python/ray/data/iterator.py`` (``iter_batches`` at
``dataset.py:3837``, ``iter_torch_batches`` at ``:3908``). Torch batches go
straight onto the consumer's device: inside a Train worker that holds a GPU
that is its pinned card (``train.torch.get_device()``), elsewhere the CPU.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterator, Optional

import numpy as np

import ray_tpu_torch

from .block import BlockAccessor


class DataIterator:
    def __init__(self, dataset):
        self._dataset = dataset

    def _iter_blocks(self):
        for ref in self._dataset._stream_refs():
            yield ray_tpu_torch.get(ref)

    def iter_batches(self, *, batch_size: int = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     local_shuffle_buffer_size: Optional[int] = None,
                     local_shuffle_seed: Optional[int] = None
                     ) -> Iterator[Any]:
        rng = np.random.RandomState(local_shuffle_seed)
        carry = None  # leftover rows as an arrow table
        shuffle_buf = deque()
        buffered_rows = 0

        def emit(table):
            return BlockAccessor(table).to_batch(batch_format)

        for block in self._iter_blocks():
            if carry is not None:
                block = BlockAccessor.concat([carry, block])
                carry = None
            if local_shuffle_buffer_size:
                shuffle_buf.append(block)
                buffered_rows += block.num_rows
                if buffered_rows < local_shuffle_buffer_size:
                    continue
                merged = BlockAccessor.concat(list(shuffle_buf))
                shuffle_buf.clear()
                buffered_rows = 0
                block = merged.take(rng.permutation(merged.num_rows))
            n = block.num_rows
            start = 0
            while n - start >= batch_size:
                yield emit(block.slice(start, batch_size))
                start += batch_size
            if start < n:
                carry = block.slice(start, n - start)
        if shuffle_buf:
            merged = BlockAccessor.concat(list(shuffle_buf))
            if carry is not None:
                merged = BlockAccessor.concat([carry, merged])
            carry = merged.take(rng.permutation(merged.num_rows))
        if carry is not None and carry.num_rows:
            n = carry.num_rows
            start = 0
            while n - start >= batch_size:
                yield emit(carry.slice(start, batch_size))
                start += batch_size
            if start < n and not drop_last:
                yield emit(carry.slice(start, n - start))

    def iter_rows(self) -> Iterator[dict]:
        for block in self._iter_blocks():
            yield from BlockAccessor(block).rows()

    def iter_torch_batches(self, *, batch_size: int = 256,
                           dtypes: Optional[Dict[str, Any]] = None,
                           device: Any = "auto",
                           drop_last: bool = False,
                           **kw) -> Iterator[Dict[str, Any]]:
        """Torch-tensor batches on ``device`` (reference:
        ``DataIterator.iter_torch_batches``). ``dtypes`` maps a column to
        a torch dtype, applied after the tensor is made (so on the
        device: an int32 column crosses to the card at half an int64's
        bytes). ``device="auto"`` is the worker's pinned card inside a
        Train worker that holds a GPU, else the CPU; any other value is
        taken as given.

        The batches are views of store pages, which are read-only: a CPU
        batch is copied so that its tensor may be written, a CUDA batch is
        copied into pinned host memory and from there to the card."""
        import torch

        from .dataset import _tensorable

        device = _resolve_device(device)
        for batch in self.iter_batches(batch_size=batch_size,
                                       batch_format="numpy",
                                       drop_last=drop_last, **kw):
            out = {}
            for k, v in batch.items():
                arr = _tensorable(v)
                if device.type == "cpu":
                    t = torch.as_tensor(arr if arr.flags.writeable
                                        else arr.copy())
                else:
                    host = torch.empty(arr.shape, pin_memory=True,
                                       dtype=_torch_dtype(arr.dtype))
                    np.copyto(host.numpy(), arr)
                    t = host.to(device, non_blocking=True)
                if dtypes and k in dtypes:
                    t = t.to(dtypes[k])
                out[k] = t
            yield out

    def materialize(self):
        return self._dataset.materialize()

    def stats(self) -> str:
        return self._dataset.stats()


def _resolve_device(device):
    """``"auto"``: ``train.torch.get_device()`` inside a Train worker
    (its pinned card, or the CPU when it holds no GPU), else the CPU."""
    import torch

    if isinstance(device, str) and device == "auto":
        from ..train import session

        if session._session is None:
            return torch.device("cpu")
        from ..train.torch import get_device

        return get_device()
    return torch.device(device)


def _torch_dtype(dtype: np.dtype):
    import torch

    return torch.from_numpy(np.empty(0, dtype)).dtype
