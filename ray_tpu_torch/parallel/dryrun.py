"""One full sharded train step over an n-rank mesh at tiny shapes: the
port's counterpart of ``__graft_entry__.dryrun_multichip``.

``dryrun_rank`` is one rank's body, a plain function that runs inside a
process group someone else started (the tests call it in theirs);
``dryrun_multichip`` spawns the ``n`` processes, joins them in a group and
runs it. The mesh is factored as the reference's: ``tp`` and ``sp`` take 2
where they divide, ``fsdp`` the rest. The reference's pipeline, MoE,
multi-host and MPMD sub-dryruns and its 8B certificate wait for the port
of those parts, and are reported as not run.
"""

from __future__ import annotations

import json
import math
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .._device import resolve_device
from ..models.convert import trainable
from ..models.llama import LlamaConfig, init_params
from .collectives import allreduce
from .mesh import MeshSpec, make_mesh
from .ring_attention import make_ring_attention
from .sharding import shard_params, shardings_for_tree
from .training import SPLIT_AXES, allreduce_grads, sharded_loss_fn

#: The reference's dryrun model (``__graft_entry__.py``), in fp32.
DRYRUN_CFG = LlamaConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=8,
                         n_kv_heads=4, d_ff=128, max_seq_len=128,
                         dtype=torch.float32)
#: The reference's parts that the port's dryrun does not run yet.
NOT_RUN = ("_dryrun_pipeline", "_dryrun_moe", "_dryrun_multihost",
           "_dryrun_mpmd_pipeline", "_report_8b_cert")


def dryrun_spec(n_devices: int) -> MeshSpec:
    """``tp`` = 2 and ``sp`` = 2 where they divide ``n_devices``, ``fsdp``
    the rest."""
    tp = 2 if n_devices % 2 == 0 else 1
    sp = 2 if n_devices % (tp * 2) == 0 else 1
    return MeshSpec(tp=tp, sp=sp, fsdp=-1).resolve(n_devices)


def dryrun_inputs(spec: MeshSpec, device):
    """The dryrun's global weights (seed 0) and tokens (seed 1) on
    ``device``."""
    device = resolve_device(device)
    params = init_params(DRYRUN_CFG, torch.Generator(device).manual_seed(0),
                         device=device)
    batch = max(4, spec.fsdp * spec.dp * 2)
    tokens = torch.randint(0, DRYRUN_CFG.vocab_size, (batch, 64),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    return params, tokens


def dryrun_rank(n_devices: int, device=None, backend=None) -> float:
    """One AdamW step of ``DRYRUN_CFG`` on this rank's shards, through the
    ring, in a process group of ``n_devices`` ranks that is already
    initialised; returns the global loss (the same on every rank) and
    raises if it is not finite. Rank 0 prints the reference's line."""
    spec = dryrun_spec(n_devices)
    mesh = make_mesh(spec, device=device, backend=backend)
    params, tokens = dryrun_inputs(spec, mesh.device)
    specs = shardings_for_tree(params, mesh)
    shards = shard_params(params, mesh, specs)
    del params
    opt = torch.optim.AdamW(trainable(shards), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    share = sharded_loss_fn(shards, tokens, DRYRUN_CFG, mesh,
                            attn_impl=make_ring_attention(mesh, causal=True),
                            remat=True, specs=specs)
    share.backward()
    allreduce_grads(shards, mesh, specs)
    opt.step()
    loss = float(allreduce(share.detach(), mesh, SPLIT_AXES))
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss in dryrun: {loss}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip({n_devices}): mesh="
              f"{ {a: n for a, n in mesh.shape.items() if n > 1} } "
              f"loss={loss:.4f} OK; not run (not ported yet): "
              f"{', '.join(NOT_RUN)}", flush=True)
    return loss


def _child(rank, n_devices, tmp, device, backend):
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        store=dist.FileStore(os.path.join(tmp, "store"), n_devices),
        rank=rank, world_size=n_devices)
    try:
        loss = dryrun_rank(n_devices, device=device, backend=backend)
        if rank == 0:
            with open(os.path.join(tmp, "loss.json"), "w") as f:
                json.dump(loss, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, backend=None) -> float:
    """Spawn ``n_devices`` processes, join them in a process group through
    a file store and run ``dryrun_rank`` in each; returns the loss. On
    CUDA rank r takes card ``r % device_count``; the group is NCCL unless
    ``backend`` names another (``"gloo"`` puts several ranks on one card).
    A failed rank raises here."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_child, args=(n_devices, tmp, str(device), backend),
                 nprocs=n_devices, join=True)
        with open(os.path.join(tmp, "loss.json")) as f:
            return json.load(f)
