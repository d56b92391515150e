"""One full sharded train step over an n-rank mesh at tiny shapes: the
port's counterpart of ``__graft_entry__.dryrun_multichip``.

``dryrun_rank`` is one rank's body, a plain function that runs inside a
process group someone else started (the tests call it in theirs);
``dryrun_multichip`` spawns the ``n`` processes, joins them in a group and
runs it. The mesh is factored as the reference's: ``tp`` and ``sp`` take 2
where they divide, ``fsdp`` the rest. Where 4 divides ``n``, the
reference's pipeline part (``pp`` = 2 x ``tp`` = 2, ``dp`` the rest, two
microbatches) and its MoE part (a small Mixtral on ``ep`` = 2 x ``tp`` =
2) follow, one AdamW step each. ``dryrun_multichip`` then runs the
reference's MPMD part (``dryrun_mpmd_pipeline``): three stage actors of
the port's runtime, on the same device. The reference's multi-host
sub-dryrun and its 8B certificate wait for the port of those parts, and
are reported as not run.
"""

from __future__ import annotations

import datetime
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
from .pipeline import make_pipelined_loss, pipelined_specs, to_pipeline_params
from .ring_attention import make_ring_attention
from .sharding import shard_params, shardings_for_tree
from .training import SPLIT_AXES, allreduce_grads, sharded_loss_fn

#: The reference's dryrun model (``__graft_entry__.py``), in fp32.
DRYRUN_DIMS = dict(vocab_size=512, d_model=64, n_layers=2, n_heads=8,
                   n_kv_heads=4, d_ff=128, max_seq_len=128)
DRYRUN_CFG = LlamaConfig(**DRYRUN_DIMS, dtype=torch.float32)
#: The reference's MoE part's model: DRYRUN_CFG's widths, 4 experts, top
#: 2, and its MoE's capacity factor (``moe_cfg``).
DRYRUN_MOE = dict(n_experts=4, top_k=2, capacity_factor=4.0)
#: How long a rank waits on a collective before it fails the run.
RANK_TIMEOUT = datetime.timedelta(seconds=600)
#: The pipeline part's microbatches.
DRYRUN_MICROBATCHES = 2
#: The reference's parts that the port's dryrun does not run yet.
NOT_RUN = ("_dryrun_multihost", "_report_8b_cert")
#: The MPMD part's model and batch (the reference's ``_dryrun_mpmd_pipeline``).
MPMD_DIMS = dict(vocab_size=128, d_model=32, n_layers=4, n_heads=4,
                 n_kv_heads=2, d_ff=64, max_seq_len=32)
MPMD_TOKENS = (8, 16)


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


def pipeline_spec(n_devices: int) -> MeshSpec:
    """The pipeline part's mesh: ``pp`` = 2 x ``tp`` = 2, ``dp`` the
    rest."""
    return MeshSpec(pp=2, tp=2, dp=-1).resolve(n_devices)


def moe_spec(n_devices: int) -> MeshSpec:
    """The MoE part's mesh: ``ep`` = 2 x ``tp`` = 2, ``dp`` the rest."""
    return MeshSpec(ep=2, tp=2, dp=-1).resolve(n_devices)


def pipeline_inputs(spec: MeshSpec, device):
    """The pipeline part's global weights (seed 0, pipelined) and tokens
    [4 dp, 32] (seed 1)."""
    params, _ = dryrun_inputs(spec, device)
    tokens = torch.randint(0, DRYRUN_CFG.vocab_size, (spec.dp * 4, 32),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    return to_pipeline_params(params), tokens


def _mixtral():
    # models.mixtral imports parallel.moe, whose package imports this module
    from ..models import mixtral

    return mixtral


def moe_cfg():
    """The MoE part's model, ``DRYRUN_MOE`` on ``DRYRUN_CFG``."""
    return _mixtral().MixtralConfig(**DRYRUN_DIMS, **DRYRUN_MOE,
                                    dtype=torch.float32)


def moe_inputs(spec: MeshSpec, device):
    """The MoE part's global weights (seed 0) and tokens [2 dp ep fsdp,
    32] (seed 1)."""
    cfg = moe_cfg()
    params = _mixtral().init_params(
        cfg, torch.Generator(device).manual_seed(0), device=device)
    rows = 2 * spec.dp * spec.ep * spec.fsdp
    tokens = torch.randint(0, cfg.vocab_size, (rows, 32),
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    return params, tokens


def _step(loss_fn, params, specs, mesh, what: str) -> float:
    """One AdamW step of ``loss_fn(shards) -> share`` on this rank's shards
    of ``params``; the global loss, which must be finite."""
    shards = shard_params(params, mesh, specs)
    opt = torch.optim.AdamW(trainable(shards), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-4)
    share = loss_fn(shards)
    share.backward()
    allreduce_grads(shards, mesh, specs)
    opt.step()
    loss = float(allreduce(share.detach(), mesh, SPLIT_AXES))
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite {what} loss in dryrun: {loss}")
    return loss


def _axes(mesh) -> dict:
    return {a: n for a, n in mesh.shape.items() if n > 1}


def dryrun_rank(n_devices: int, device=None, backend=None) -> dict:
    """One AdamW step of ``DRYRUN_CFG`` on this rank's shards, through the
    ring, in a process group of ``n_devices`` ranks that is already
    initialised; where 4 divides ``n_devices``, then one step of the same
    model pipelined over ``pipeline_spec`` and one of ``moe_cfg()``
    over ``moe_spec`` (``make_ep_moe_ffn``). Returns each part's global
    loss by name (``"sharded"``, ``"pipeline"``, ``"moe"``; the same on
    every rank) and raises if one is not finite. Rank 0 prints the
    reference's lines."""
    spec = dryrun_spec(n_devices)
    mesh = make_mesh(spec, device=device, backend=backend)
    params, tokens = dryrun_inputs(spec, mesh.device)
    specs = shardings_for_tree(params, mesh)
    ring = make_ring_attention(mesh, causal=True)
    losses = {"sharded": _step(
        lambda p: sharded_loss_fn(p, tokens, DRYRUN_CFG, mesh,
                                  attn_impl=ring, remat=True, specs=specs),
        params, specs, mesh, "sharded")}
    lines = [f"dryrun_multichip({n_devices}): mesh={_axes(mesh)} "
             f"loss={losses['sharded']:.4f} OK"]
    if n_devices % 4 == 0:
        pmesh = make_mesh(pipeline_spec(n_devices), device=device,
                          backend=backend)
        params, tokens = pipeline_inputs(pmesh.spec, pmesh.device)
        specs = pipelined_specs(params, pmesh)
        ploss = make_pipelined_loss(pmesh, DRYRUN_CFG, DRYRUN_MICROBATCHES)
        losses["pipeline"] = _step(lambda p: ploss(p, tokens, specs),
                                   params, specs, pmesh, "pipeline")
        lines.append(f"dryrun pipeline: mesh={_axes(pmesh)} "
                     f"loss={losses['pipeline']:.4f} OK")
        emesh = make_mesh(moe_spec(n_devices), device=device,
                          backend=backend)
        params, tokens = moe_inputs(emesh.spec, emesh.device)
        mixtral = _mixtral()
        specs = mixtral.mixtral_shardings(params, emesh)
        losses["moe"] = _step(
            lambda p: sharded_loss_fn(p, tokens, moe_cfg(), emesh,
                                      remat=True, specs=specs,
                                      forward=mixtral.sharded_forward),
            params, specs, emesh, "moe")
        lines.append(f"dryrun moe: mesh={_axes(emesh)} "
                     f"loss={losses['moe']:.4f} OK")
    if dist.get_rank() == 0:
        lines.append(f"not run (not ported yet): {', '.join(NOT_RUN)}")
        print("\n".join(lines), flush=True)
    return losses


def _child(rank, n_devices, tmp, device, backend):
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        store=dist.FileStore(os.path.join(tmp, "store"), n_devices),
        rank=rank, world_size=n_devices, timeout=RANK_TIMEOUT)
    try:
        losses = dryrun_rank(n_devices, device=device, backend=backend)
        if rank == 0:
            with open(os.path.join(tmp, "loss.json"), "w") as f:
                json.dump(losses, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """Spawn ``n_devices`` processes, join them in a process group through
    a file store and run ``dryrun_rank`` in each; then, for two or more
    devices, ``dryrun_mpmd_pipeline``. Returns the parts' losses. On CUDA
    rank r takes card ``r % device_count``; the group is NCCL unless
    ``backend`` names another (``"gloo"`` puts several ranks on one card).
    A failed rank raises here."""
    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_child, args=(n_devices, tmp, str(device), backend),
                 nprocs=n_devices, join=True)
        with open(os.path.join(tmp, "loss.json")) as f:
            losses = json.load(f)
    if n_devices >= 2:
        losses["mpmd"] = dryrun_mpmd_pipeline(device)["loss"]
    return losses


def mpmd_inputs():
    """The MPMD part's fp32 untied model and tokens, from seeds 0 and 1."""
    cfg = LlamaConfig(**MPMD_DIMS, dtype=torch.float32,
                      tie_embeddings=False)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, MPMD_TOKENS,
                           generator=torch.Generator().manual_seed(1))
    return cfg, params, tokens


def dryrun_mpmd_pipeline(device=None) -> dict:
    """The cross-process MPMD pipeline's certification (the reference's
    ``_dryrun_mpmd_pipeline``): three stage actors of the port's runtime
    (compiled-DAG hops on the object plane, the 1F1B in-flight bound), 8
    microbatches, must reproduce the single-program loss within 1e-4 and
    consume every saved forward; the bubble fraction is printed. Then a
    run whose stage compute is a calibrated sleep (so the stage processes
    overlap on any host) must bound the live saved forwards by the depth
    and measure a bubble well under a serialized schedule's (~0.67).
    The stages run on ``device``, CUDA unless the caller names another (on
    one card they share it). Starts a cluster of three CPUs, and the
    host's cards on CUDA, unless one is running. Returns the loss, the
    single-program loss and both bubble fractions."""
    import ray_tpu_torch

    from ..models.llama import loss_fn
    from .mpmd_pipeline import MPMDPipeline

    device = resolve_device(device)
    started = not ray_tpu_torch.is_initialized()
    if started:
        ray_tpu_torch.init(num_cpus=3, probe_gpu=False, num_gpus=(
            torch.cuda.device_count() if device.type == "cuda" else 0))
    try:
        cfg, params, tokens = mpmd_inputs()
        with torch.no_grad():
            ref_loss = float(loss_fn(params, {"tokens": tokens}, cfg,
                                     remat=True))
        pipe = MPMDPipeline(cfg, params, n_stages=3, n_microbatches=8,
                            schedule="1f1b", device=device)
        try:
            loss = pipe.grad_check_step(tokens)
            stats = pipe.last_step_stats
            vjps = pipe.live_vjp_counts()
        finally:
            pipe.teardown()
        if abs(loss - ref_loss) >= 1e-4:
            raise AssertionError(f"mpmd dryrun loss {loss} against the "
                                 f"single program's {ref_loss}")
        if vjps != [0, 0, 0]:
            raise AssertionError(f"unconsumed VJPs after step: {vjps}")
        print(f"dryrun mpmd pipeline: 3-stage 1F1B stage actors OK "
              f"loss={loss:.6f} (single-program {ref_loss:.6f}, "
              f"parity {abs(loss - ref_loss):.2e}) "
              f"microbatches=8 bubble_fraction="
              f"{stats['bubble_fraction']:.2f} "
              f"stage_busy_s={[round(b, 3) for b in stats['stage_busy_s']]}",
              flush=True)
        sim = MPMDPipeline(cfg, params, n_stages=3, n_microbatches=8,
                           schedule="1f1b", simulate_compute_s=0.1,
                           device=device)
        try:
            sim.step(tokens)          # warmup
            sim.peak_vjp_counts()     # reset high-water marks
            sim.step(tokens)
            sstats = sim.last_step_stats
            analytic = sim.analytic_bubble_fraction()
            peaks = sim.peak_vjp_counts()
        finally:
            sim.teardown()
        if max(peaks) > 3:
            raise AssertionError(
                f"1F1B must bound live VJPs by depth: {peaks}")
        if sstats["bubble_fraction"] >= 0.4:
            raise AssertionError(f"sleep-bound 1F1B bubble: {sstats}")
        print(f"dryrun mpmd schedule: sleep-bound 1F1B bubble_fraction="
              f"{sstats['bubble_fraction']:.3f} vs analytic "
              f"(p-1)/(m+p-1)={analytic:.3f} (p=3, m=8); "
              f"peak_live_vjps={peaks} (depth-bounded)", flush=True)
        return {"loss": loss, "ref_loss": ref_loss,
                "bubble_fraction": stats["bubble_fraction"],
                "sim_bubble_fraction": sstats["bubble_fraction"]}
    finally:
        if started:
            ray_tpu_torch.shutdown()
