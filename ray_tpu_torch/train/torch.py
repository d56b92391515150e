"""``ray_tpu_torch.train.torch`` — the reference's ``ray.train.torch`` import
surface: ``TorchTrainer`` and the worker-side helpers.

Reference: ``ray_tpu/train/torch.py`` and ``torch_trainer.py:48-97``
(``prepare_model``, ``prepare_data_loader``, ``get_device``,
``backward``). In the port a worker that holds a GPU is pinned to its card:
the runtime sets ``CUDA_VISIBLE_DEVICES`` to its id, so the card is
``cuda:0`` in the worker, the device ``TrainWorker.setup_torch_distributed``
makes current. ``get_device`` returns it, and ``prepare_model`` moves the
model there before it wraps it in DDP.
"""

from __future__ import annotations

from .trainer import TorchTrainer

__all__ = ["TorchTrainer", "prepare_model", "prepare_data_loader",
           "get_device", "backward"]


def get_device():
    """This worker's device: ``cuda:0``, its pinned card, when it holds a
    GPU; the CPU when it holds none. A worker that holds a GPU but finds
    no CUDA raises rather than train on the CPU."""
    import os

    import torch

    import ray_tpu_torch

    if not ray_tpu_torch.get_gpu_ids():
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"this worker holds GPU {ray_tpu_torch.get_gpu_ids()} "
            f"(CUDA_VISIBLE_DEVICES="
            f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r}) "
            f"but torch finds no CUDA device")
    return torch.device("cuda", 0)


def prepare_model(model, *, find_unused_parameters: bool = False):
    """Move the model to ``get_device()`` and DDP-wrap it when a >1-rank
    process group is live, with ``device_ids`` on CUDA (reference:
    ``ray.train.torch.prepare_model``, ``train/torch/train_loop_utils``)."""
    import torch.distributed as dist

    device = get_device()
    model = model.to(device)
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        ids = [device.index] if device.type == "cuda" else None
        return DistributedDataParallel(
            model, device_ids=ids, output_device=ids[0] if ids else None,
            find_unused_parameters=find_unused_parameters)
    return model


def prepare_data_loader(loader):
    """Re-build a DataLoader with a DistributedSampler so every rank sees
    a disjoint shard (reference: ``prepare_data_loader``). The original
    loader's configuration is preserved: shuffle intent (detected from
    its sampler), batch size, workers, pin_memory, collate/drop_last.
    Call ``loader.sampler.set_epoch(epoch)`` per epoch for fresh
    shuffles (same contract as the reference)."""
    import torch.distributed as dist
    from torch.utils.data import DataLoader, RandomSampler
    from torch.utils.data.distributed import DistributedSampler

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return loader
    if loader.batch_size is None:
        raise ValueError(
            "prepare_data_loader cannot re-shard a DataLoader built with "
            "a custom batch_sampler; pass batch_size/shuffle instead")
    shuffle = isinstance(loader.sampler, RandomSampler)
    sampler = DistributedSampler(loader.dataset, shuffle=shuffle)
    return DataLoader(loader.dataset, batch_size=loader.batch_size,
                      sampler=sampler, num_workers=loader.num_workers,
                      pin_memory=loader.pin_memory,
                      collate_fn=loader.collate_fn,
                      drop_last=loader.drop_last)


def backward(loss):
    loss.backward()
