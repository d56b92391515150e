"""One full sharded train step over an n-rank mesh at tiny shapes: the
port's counterpart of ``__graft_entry__.dryrun_multichip``.

``dryrun_rank`` is one rank's body, a plain function that runs inside a
process group someone else started (the tests call it in theirs);
``dryrun_multichip`` spawns the ``n`` processes, joins them in a group and
runs it. The mesh is factored as the reference's: ``tp`` and ``sp`` take 2
where they divide, ``fsdp`` the rest. Where 4 divides ``n``, the
reference's pipeline part (``pp`` = 2 x ``tp`` = 2, ``dp`` the rest, two
microbatches) and its MoE part (a small Mixtral on ``ep`` = 2 x ``tp`` =
2) follow, one AdamW step each. For two or more devices
``dryrun_multichip`` then runs the reference's multi-host part
(``dryrun_multihost``: two launcher processes whose ranks meet at a TCP
address, as nodes under ``torchrun`` do, and take one step across them)
and its MPMD part (``dryrun_mpmd_pipeline``: three stage actors of the
port's runtime, on the same device). Last come the reference's two 8B
certificate reports (``report_8b_cert``, ``report_8b_mpmd_cert``), built
from the package's own memory model and stage lowering, each reckoned for
the card it names.
"""

from __future__ import annotations

import datetime
import json
import math
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .._device import resolve_device
from ..models.convert import trainable
from ..models.llama import LLAMA3_8B, LlamaConfig, init_params
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
#: How long the multi-host part waits for its launchers, their
#: rendezvous included, before it kills them and fails (the reference's
#: 240 s).
MULTIHOST_TIMEOUT_S = 240.0
#: The multi-host step's global rows (two a launcher) and width, and its
#: loss: mean((x @ I)^2) over rows of 1 (launcher 0) and 2 (launcher 1).
MULTIHOST_ROWS, MULTIHOST_WIDTH = 2, 8
MULTIHOST_LOSS = 2.5
#: The 8B certificate's geometry (``benchmarks/certify_8b.py``'s): seq
#: 8192, remat and the chunked loss's vocab chunk, 64 devices as one FSDP
#: program or as 4 pipeline stages of 16, 8 microbatches (m = 2p).
CERT_SEQ = 8192
CERT_CHUNK = 16384
CERT_DEVICES = 64
CERT_STAGES = 4
CERT_MICROBATCHES = 8
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


def card_memory(device) -> tuple:
    """``(name, GiB)`` of the CUDA card ``device``, as the reports name
    it."""
    props = torch.cuda.get_device_properties(device)
    return props.name, props.total_memory / 2**30


def dryrun_multichip(n_devices: int, device=None, backend=None,
                     hbm_gib_per_chip=None) -> dict:
    """Spawn ``n_devices`` processes, join them in a process group through
    a file store and run ``dryrun_rank`` in each; then, for two or more
    devices, ``dryrun_multihost`` and ``dryrun_mpmd_pipeline``; last the
    two 8B reports, reckoned for the card's memory on CUDA
    (``card_memory``) and for ``hbm_gib_per_chip``, which the caller
    states, on the CPU. Returns the parts' losses. On CUDA rank r takes
    card ``r % device_count``; the group is NCCL unless ``backend`` names
    another (``"gloo"`` puts several ranks on one card). A failed rank
    raises here."""
    device = resolve_device(device)
    card = None
    if hbm_gib_per_chip is None:
        if device.type != "cuda":
            raise ValueError("the 8B reports need the card's memory: pass "
                             "hbm_gib_per_chip off CUDA")
        card, hbm_gib_per_chip = card_memory(device)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_child, args=(n_devices, tmp, str(device), backend),
                 nprocs=n_devices, join=True)
        with open(os.path.join(tmp, "loss.json")) as f:
            losses = json.load(f)
    if n_devices >= 2:
        losses["multihost"] = dryrun_multihost(n_devices, device)["loss"]
        losses["mpmd"] = dryrun_mpmd_pipeline(device)["loss"]
    report_8b_cert(hbm_gib_per_chip, card)
    report_8b_mpmd_cert(hbm_gib_per_chip, card)
    return losses


# ------------------------------------------------------------ multi-host


def multihost_step(per_launcher: int, device) -> float:
    """The reference's cross-process step, in a process group of two
    launchers of ``per_launcher`` ranks each: a mesh with ``dp`` across
    the launchers and ``tp`` inside each, the launcher's
    ``MULTIHOST_ROWS`` rows of ``MULTIHOST_WIDTH`` holding its index + 1,
    and ``mean((x @ eye) ** 2)`` with the identity's columns split over
    ``tp`` and the sum reduced over both axes."""
    mesh = make_mesh(MeshSpec(dp=2, tp=per_launcher), device=device,
                     backend="gloo")
    x = torch.full((MULTIHOST_ROWS, MULTIHOST_WIDTH),
                   float(mesh.coords["dp"] + 1), device=mesh.device)
    cols = torch.eye(MULTIHOST_WIDTH, device=mesh.device).tensor_split(
        per_launcher, dim=1)[mesh.coords["tp"]]
    total = allreduce(((x @ cols) ** 2).sum(), mesh, ("dp", "tp"))
    return float(total) / (2 * MULTIHOST_ROWS * MULTIHOST_WIDTH)


def multihost_rank_main(address: str, launcher: str, per_launcher: str,
                        local: str, device: str) -> int:
    """One rank of ``dryrun_multihost``, rank ``launcher x per_launcher +
    local``: join the group at ``address`` and print this rank's
    ``multihost_step`` loss. Returns the exit code."""
    launcher, per, local = int(launcher), int(per_launcher), int(local)
    rank = launcher * per + local
    device = resolve_device(device)
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        "gloo", init_method=address, rank=rank, world_size=2 * per,
        timeout=datetime.timedelta(seconds=MULTIHOST_TIMEOUT_S))
    try:
        loss = multihost_step(per, device)
    finally:
        dist.destroy_process_group()
    print(f"loss={loss!r}", flush=True)
    return 0


# A launcher (a node under ``torchrun``): it imports nothing of torch, so
# its ranks start at once; each rank's process imports the port. It
# prints RDZV_OK once every rank's loss is the expected one to 1e-6.
_MULTIHOST_LAUNCHER = """
import subprocess, sys
address, launcher, per, device, expect = sys.argv[1:]
rank_main = ("import sys; from ray_tpu_torch.parallel.dryrun import "
             "multihost_rank_main as m; sys.exit(m(*sys.argv[1:]))")
procs = [subprocess.Popen([sys.executable, "-c", rank_main, address,
                           launcher, per, str(r), device],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True) for r in range(int(per))]
outs = [p.communicate()[0] for p in procs]
losses = [float(o.rsplit("loss=", 1)[1]) if p.returncode == 0 else None
          for p, o in zip(procs, outs)]
ranks = [int(launcher) * int(per) + r for r in range(int(per))]
if any(x is None or abs(x - float(expect)) >= 1e-6 for x in losses):
    print(f"launcher {launcher}: ranks {ranks} losses {losses}", *outs,
          sep="\\n", flush=True)
    sys.exit(1)
print(f"RDZV_OK launcher={launcher} ranks={ranks} world={2 * int(per)} "
      f"loss={losses[0]}", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multihost(n_devices: int, device=None) -> dict:
    """The reference's multi-host part: two launcher processes (started
    with ``subprocess``, each its own session) of ``n_devices // 2`` rank
    processes each (``multihost_rank_main``) meet through
    ``torch.distributed`` at ``tcp://127.0.0.1:<port>`` (rank = launcher x
    per launcher + local rank) and compute
    ``multihost_step`` across processes, over gloo on ``device`` (CUDA
    unless named; several ranks may share a card). Each launcher must
    print ``RDZV_OK``; a hung rendezvous fails after
    ``MULTIHOST_TIMEOUT_S``, its processes killed. Returns the loss and
    the launchers' lines."""
    device = resolve_device(device)
    per = max(n_devices // 2, 1)
    address = f"tcp://127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MULTIHOST_LAUNCHER, address, str(i),
         str(per), str(device), str(MULTIHOST_LOSS)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True) for i in (0, 1)]
    # the rendezvous' own timeout, and the launchers' imports before it
    deadline = time.monotonic() + MULTIHOST_TIMEOUT_S + 60
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"multihost dryrun timed out after "
                           f"{MULTIHOST_TIMEOUT_S} s (rendezvous hung at "
                           f"{address})") from None
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, out in zip(procs, outs):
        if p.returncode != 0 or "RDZV_OK" not in out:
            raise RuntimeError(f"multihost dryrun launcher failed (rc="
                               f"{p.returncode}):\n{out[-2000:]}")
    tail = [ln for o in outs for ln in o.splitlines() if "RDZV_OK" in ln]
    loss = float(tail[0].rsplit("loss=", 1)[1])
    print(f"dryrun multihost: 2-launcher torch.distributed rendezvous at "
          f"{address} OK ({per} ranks a launcher, gloo on {device.type}) "
          f"loss={loss} - {'; '.join(tail)}", flush=True)
    return {"loss": loss, "lines": tail}


# ------------------------------------------------------ the 8B certificate


def _card(hbm_gib_per_chip: float, card=None) -> str:
    return (f"{card} ({hbm_gib_per_chip:.2f} GiB a card)" if card
            else f"a card of {hbm_gib_per_chip:.2f} GiB")


def _largest_batch(budget) -> int:
    """The largest power-of-two batch a card whose ``budget(batch)``
    fits (the reference's doubling), 0 if one row does not."""
    if not budget(1)["fits"]:
        return 0
    b = 1
    while budget(b * 2)["fits"]:
        b *= 2
    return b


def report_8b_cert(hbm_gib_per_chip: float, card=None) -> dict:
    """The reference's ``_report_8b_cert``, from the package's memory model
    instead of a record: ``LLAMA3_8B`` as one FSDP program over
    ``CERT_DEVICES`` devices at seq ``CERT_SEQ``, remat and the chunked
    loss (``stage_hbm_budget`` with one stage), for a card of
    ``hbm_gib_per_chip`` GiB (named ``card``): its GiB a card at batch 1,
    whether it fits and the largest batch a card that fits. Prints one
    line and returns the budget and that batch."""
    from .mpmd_pipeline import stage_hbm_budget

    def budget(batch):
        return stage_hbm_budget(
            LLAMA3_8B, 1, 0, devices_per_stage=CERT_DEVICES,
            batch_per_chip=batch, seq=CERT_SEQ, n_microbatches=1,
            chunk_v=CERT_CHUNK, hbm_gib_per_chip=hbm_gib_per_chip)

    b, bmax = budget(1), _largest_batch(budget)
    print(f"8b_fsdp{CERT_DEVICES}: Llama-3-8B "
          f"({LLAMA3_8B.param_count():,} parameters) as one fsdp = "
          f"{CERT_DEVICES} program, seq {CERT_SEQ}, remat and the chunked "
          f"loss (chunk {CERT_CHUNK}), reckoned for "
          f"{_card(hbm_gib_per_chip, card)}: "
          f"{b['total_gib_per_chip']} GiB a card at batch 1, "
          f"fits={b['fits']}, the largest batch a card that fits {bmax} "
          f"(stage_hbm_budget's model)", flush=True)
    return {"budget": b, "max_batch_per_chip": bmax}


def report_8b_mpmd_cert(hbm_gib_per_chip: float, card=None) -> dict:
    """The reference's ``_report_8b_mpmd_cert``, from the package itself:
    ``LLAMA3_8B`` as ``CERT_STAGES`` pipeline stages, each an FSDP program
    of ``CERT_DEVICES / CERT_STAGES`` devices (``stage_submesh``), 1F1B
    over ``CERT_MICROBATCHES`` microbatches: each stage's
    ``stage_hbm_budget`` a card with its 1F1B depth, whether all fit and
    each stage's largest batch a card, beside each stage's step traced at
    the full geometry by ``lower_stage_step`` and its argument GiB a rank.
    The reference's measured bubble fractions come from
    ``benchmarks/certify_8b.py``'s bubble child, which stays with the
    benchmark folder: the line says they are not reported. Prints one
    line and returns the budgets, the batches and the lowerings' bytes."""
    from .mpmd_pipeline import lower_stage_step, stage_hbm_budget
    from .sharding import stage_submesh

    per = CERT_DEVICES // CERT_STAGES

    def budget(i, batch):
        return stage_hbm_budget(
            LLAMA3_8B, CERT_STAGES, i, devices_per_stage=per,
            batch_per_chip=batch, seq=CERT_SEQ,
            n_microbatches=CERT_MICROBATCHES, chunk_v=CERT_CHUNK,
            hbm_gib_per_chip=hbm_gib_per_chip)

    budgets = [budget(i, 1) for i in range(CERT_STAGES)]
    bmax = [_largest_batch(lambda b, i=i: budget(i, b))
            for i in range(CERT_STAGES)]
    mesh = stage_submesh(per, device="meta")
    lowered = [lower_stage_step(LLAMA3_8B, i, CERT_STAGES, mesh,
                                batch=per, seq=CERT_SEQ,
                                chunked_vocab=CERT_CHUNK)
               for i in range(CERT_STAGES)]
    args = [lw.argument_size_in_bytes for lw in lowered]
    print(f"8b_pp{CERT_STAGES}_fsdp{per}: Llama-3-8B as {CERT_STAGES} "
          f"stage programs of fsdp = {per}, seq {CERT_SEQ}, remat and the "
          f"chunked loss, 1F1B over {CERT_MICROBATCHES} microbatches "
          f"(depth {[b['depth_1f1b'] for b in budgets]}), reckoned for "
          f"{_card(hbm_gib_per_chip, card)}: GiB a card by stage "
          f"{[b['total_gib_per_chip'] for b in budgets]} (worst case "
          f"{[b['worst_case_gib_per_chip'] for b in budgets]}), all fit="
          f"{all(b['fits'] for b in budgets)}, the largest batch a card "
          f"{bmax}; lower_stage_step traced "
          f"{[lw.kind for lw in lowered]} at the full geometry, arguments "
          f"{[round(a / 2**30, 3) for a in args]} GiB a rank; measured "
          f"bubble fractions not reported (benchmarks/certify_8b.py's "
          f"bubble child)", flush=True)
    return {"budgets": budgets, "max_batch_per_chip": bmax,
            "argument_bytes": args,
            "output_bytes": [lw.output_size_in_bytes for lw in lowered]}


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
