"""Cross-process MPMD pipeline parallelism: stages as compiled-DAG actors.

Port of ``ray_tpu/parallel/mpmd_pipeline.py``. A pipeline across hosts
that share no fast fabric cannot be one program; each STAGE is an actor
with its own program:

  * each stage actor holds its span of a Llama tree (``split_llama_params``)
    on the card the runtime pinned it to (``train.torch.get_device()``), a
    card or a share of one by default (``stage_placement``), and on the
    CPU only where the caller asks for it (``device="cpu"``), with a local
    AdamW,
  * activations flow stage→stage through a compiled DAG's direct hops
    between the actors' own connections (device → host → serialized
    frame → host → device; the shm store is not on the path), optionally
    down-cast to ``bfloat16`` for the hop (the backward cotangents take
    the same cast),
  * the backward pass runs through the same compiled chain in reverse: the
    last stage emits the activation cotangent, each mid stage consumes it,
    finishes its saved microbatch, and emits the next one, and stage 0
    finishes the chain. A stage's saved microbatch (its "VJP") is the
    output of its forward and its detached input with ``requires_grad``;
    its backward is ``torch.autograd.backward(out, grad_out)``, and the
    input's ``.grad`` is the cotangent to send back. Both are dropped as
    soon as they are used,
  * the microbatch schedule is 1F1B-style by default: the compiled chain's
    ``max_inflight`` admits at most ``n_stages`` microbatches into the
    pipe, so each stage holds at most ``n_stages`` live VJPs.
    ``schedule="gpipe"`` admits them all at once.

Numerical contract: with equal-size microbatches, the mean of the
microbatch losses and the averaged accumulated gradients reproduce the
single-program ``llama.loss_fn`` (per-row next-token targets make the batch
split exact); AdamW takes optax's defaults, as the reference's
``optax.adamw(lr)``.

Fault plane: ``gang_name=`` registers the stage actors as a GCS gang; a
stage process killed mid-1F1B publishes a ``gang:<name>`` ``member_lost``
push, and the step fails typed (:class:`PipelineMemberLost`,
generation-stamped) in push time. Re-forming ``from_checkpoint`` under the
same gang name lands at generation+1. The hop carries the failpoint sites
``mpmd.boundary.send`` / ``mpmd.boundary.recv`` (keyed ``s<stage>``), and
each hop emits ``pipe.stage.fwd`` / ``pipe.stage.bwd`` /
``pipe.stage.boundary`` plane events. A node drain notice stops the
schedule at a microbatch boundary (:class:`PipelineDrainSignal`).

The stage math (the split, each stage's forward and loss, its parameter
count and memory budget, ``build_stage_step`` with its optax-ordered
:class:`AdamW`) needs no runtime, and neither does the 8B certificate's
machinery: ``stage_abstract_params`` (a stage's tree on ``meta``
tensors) and ``lower_stage_step`` (a stage's step traced at the full
geometry, with each rank's bytes on its FSDP submesh), which the dryrun's
8B reports read. The single-program pipeline over the ``pp`` axis is
``parallel.pipeline``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

import ray_tpu_torch

from .._device import resolve_device
from ..models import llama
from ..ops import attention
from ..ops.attention import flash_attention
from ..ops.chunked_xent import chunked_cross_entropy
from ..ops.layers import cross_entropy_loss, rms_norm, rope_frequencies
from ..ops.quant import mm

logger = logging.getLogger(__name__)


class PipelineDrainSignal(RuntimeError):
    """A node hosting a pipeline stage began DRAINING mid-schedule (a
    preemption notice, autoscaler scale-down). ``step()`` stopped
    admitting microbatches at the next boundary, let the in-flight ones
    finish their full forward+backward, applied the partial-step
    gradient (scaled by the completed count), checkpointed the MERGED
    params while the draining stage was still reachable, and raised
    this. The caller reshapes — ``MPMDPipeline.from_checkpoint`` at a
    stage count that fits the surviving nodes (drain placement exclusion
    keeps the new stage actors off the draining node) — instead of dying
    at the drain deadline mid-step."""

    def __init__(self, checkpoint_path: str, completed_microbatches: int,
                 total_microbatches: int, draining_stages,
                 reason: str = ""):
        self.checkpoint_path = checkpoint_path
        self.completed_microbatches = completed_microbatches
        self.total_microbatches = total_microbatches
        self.draining_stages = sorted(draining_stages)
        self.reason = reason
        super().__init__(
            f"pipeline drained mid-step: stage(s) {self.draining_stages} "
            f"on a draining node; {completed_microbatches}/"
            f"{total_microbatches} microbatches completed, checkpoint at "
            f"{checkpoint_path}" + (f" ({reason})" if reason else ""))

    def __reduce__(self):
        return (type(self), (self.checkpoint_path,
                             self.completed_microbatches,
                             self.total_microbatches,
                             self.draining_stages, self.reason))


class PipelineMemberLost(RuntimeError):
    """A pipeline stage's process died mid-schedule. Detection is
    PUSHED: with ``gang_name=`` set, the stage actors are registered as
    a gang and the GCS publishes ``member_lost`` the moment the stage's
    worker dies — the admission/result loops observe the event within
    one poll tick, never the 300 s result timeout. The killed stage's
    params are gone with its process, so recovery re-splits the LAST
    MERGED CHECKPOINT (``checkpoint_path`` when one was saved) at a
    stage count that fits the survivors:
    ``MPMDPipeline.from_checkpoint(..., n_stages=n-1, gang_name=same)``
    — the re-formed gang gets generation+1."""

    def __init__(self, lost_stages, n_stages: int, generation: int = 0,
                 cause: str = "", checkpoint_path: Optional[str] = None):
        self.lost_stages = sorted(
            r for r in lost_stages if isinstance(r, int))
        self.n_stages = n_stages
        self.generation = generation
        self.cause = cause
        self.checkpoint_path = checkpoint_path
        super().__init__(
            f"pipeline lost stage(s) {self.lost_stages or lost_stages} of "
            f"{n_stages} (generation {generation})"
            + (f" — {cause}" if cause else "")
            + (f"; last merged checkpoint: {checkpoint_path}"
               if checkpoint_path else ""))

    def __reduce__(self):
        return (type(self), (self.lost_stages, self.n_stages,
                             self.generation, self.cause,
                             self.checkpoint_path))

    @property
    def lost_ranks(self):
        """Alias for the train-layer escalation surface: in the stage
        gang, the stage index IS the gang rank (TrainWorker.run exports
        ``lost_ranks`` for every typed loss)."""
        return self.lost_stages


def merge_stage_params(stage_params: List[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Inverse of :func:`split_llama_params`: the stages' trees stitched
    back into one Llama tree (a re-split at any stage count sees the same
    model)."""
    if not stage_params:
        raise ValueError("no stage params to merge")
    layers: List[Any] = []
    for sp in stage_params:
        layers.extend(sp["layers"])
    return {
        "embedding": stage_params[0]["embedding"],
        "layers": layers,
        "norm": stage_params[-1]["norm"],
        "lm_head": stage_params[-1]["lm_head"],
    }


def stage_layer_counts(n_layers: int, n_stages: int) -> List[int]:
    """Each stage's layer count for an n-way split, the earlier stages
    taking the remainder: the split and the memory budget share it."""
    if n_stages < 2:
        raise ValueError("a pipeline needs at least 2 stages")
    if n_layers < n_stages:
        raise ValueError(
            f"{n_layers} layers cannot fill {n_stages} pipeline stages")
    return [n_layers // n_stages + (1 if i < n_layers % n_stages else 0)
            for i in range(n_stages)]


def split_llama_params(params: Dict[str, Any], n_stages: int
                       ) -> List[Dict[str, Any]]:
    """A Llama tree as one tree a stage: stage 0 holds the embedding and
    the first layers, the last stage the final norm and ``lm_head``.
    Raises on tied embeddings (their gradient would have to be summed
    across the first and the last stage)."""
    if "lm_head" not in params:
        raise ValueError(
            "the MPMD pipeline needs tie_embeddings=False (stage 0 holds "
            "the embedding, the last stage lm_head)")
    layers = params["layers"]
    per = stage_layer_counts(len(layers), n_stages)
    out: List[Dict[str, Any]] = []
    pos = 0
    for i in range(n_stages):
        stage: Dict[str, Any] = {"layers": layers[pos:pos + per[i]]}
        if i == 0:
            stage["embedding"] = params["embedding"]
        if i == n_stages - 1:
            stage["norm"] = params["norm"]
            stage["lm_head"] = params["lm_head"]
        out.append(stage)
        pos += per[i]
    return out


def _run_layers(stage_params, x, cfg, remat):
    cos, sin = rope_frequencies(cfg.head_dim, x.shape[1], cfg.rope_theta,
                                device=x.device)
    for layer in stage_params["layers"]:
        args = (x, layer, cos, sin, cfg, flash_attention)
        if remat and torch.is_grad_enabled():
            x = checkpoint(llama._layer, *args, use_reentrant=False)
        else:
            x = llama._layer(*args)
    return x


def stage_forward(stage_params, tokens_or_act, cfg, *, first: bool,
                  remat: bool = True):
    """One stage's layers (after the embedding on the first stage)."""
    if first:
        x = stage_params["embedding"][tokens_or_act.long()].to(cfg.dtype)
    else:
        x = tokens_or_act
    return _run_layers(stage_params, x, cfg, remat)


def stage_loss(stage_params, act, targets, cfg, *, first: bool = False,
               remat: bool = True, chunked_vocab: int = 0):
    """The last stage: its layers, the final norm, the head and the mean
    NLL. ``chunked_vocab > 0`` streams the vocab in chunks of that size
    (``ops/chunked_xent.py``), as ``llama.loss_fn`` does."""
    x = _run_layers(stage_params, act, cfg, remat)
    x = rms_norm(x, stage_params["norm"], cfg.norm_eps)
    if chunked_vocab > 0:
        B, L, D = x.shape
        return chunked_cross_entropy(
            x.reshape(B * L, D), stage_params["lm_head"],
            targets.reshape(B * L), chunked_vocab)
    logits = mm(x, stage_params["lm_head"].to(x.dtype))
    loss, _ = cross_entropy_loss(logits, targets)
    return loss


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_tensor(leaf):
    """A leaf as a detached CPU tensor (numpy arrays taken as they are)."""
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf)
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return leaf


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor)
              else None, tree)
    return out


#: The flash kernels' launch counts a stage reports (``probe``).
_COUNTS = ("launches", "bwd_launches", "stats_launches", "dense_routes")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@ray_tpu_torch.remote
class PipelineStageActor:
    """One pipeline stage. Holds its param span on its device, per-
    microbatch saved forwards (its VJPs), a local AdamW, and a busy-time
    clock (per-stage utilization → the driver's bubble-fraction
    report)."""

    def __init__(self, stage_idx: int, n_stages: int, cfg_blob: bytes,
                 params, lr: float, n_microbatches: int,
                 transport_dtype: Optional[str] = None,
                 simulate_compute_s: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None,
                 chunked_vocab: int = 0):
        import cloudpickle

        from ..models.convert import trainable
        from ..train.torch import get_device

        if env:
            # Per-stage env override (mirror of WorkerGroup's
            # env_per_worker): a re-formed pipeline running clear of the
            # schedule that killed its predecessor re-arms/disarms HERE
            # — the inherited spec was snapshotted at process import.
            os.environ.update(env)
            if ("RAY_TPU_TORCH_FAILPOINTS" in env
                    or "RAY_TPU_TORCH_FAILPOINT_SEED" in env):
                from .._private import failpoints

                failpoints.reload_failpoints()
        self.stage_idx = stage_idx
        self.generation = 0
        self.n_stages = n_stages
        self.cfg = cloudpickle.loads(cfg_blob)
        # the card this actor is pinned to; the CPU only when it holds
        # no GPU (a GPU held without CUDA raises)
        self.device = get_device()
        # copies: the received leaves are read-only views of the store
        self.params = _tree_map(lambda t: t.to(self.device, copy=True),
                                params)
        self.n_microbatches = n_microbatches
        self.transport_dtype = (getattr(torch, transport_dtype)
                                if transport_dtype else None)
        # Chunked-vocab CE on the last stage (streams the vocab softmax
        # so the full [B, L, V] fp32 logits never materialize); 0 = dense.
        self.chunked_vocab = chunked_vocab
        # Schedule-measurement mode: each hop additionally sleeps this many
        # seconds per unit of simulated compute (fwd/bwd hops 1 unit,
        # loss_bwd 2 — so every stage owes the same 2 units per
        # microbatch). Sleeping is IO-bound, so stage processes genuinely
        # overlap even on a 1-core host, which is what lets the measured
        # bubble fraction approach the analytic (p-1)/(m+p-1).
        self.simulate_compute_s = simulate_compute_s
        # optax.adamw(lr)'s defaults (torch's weight_decay is 1e-2)
        self.opt = torch.optim.AdamW(trainable(self.params), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=1e-4)
        self._vjps: Dict[int, Any] = {}
        self._peak_vjps = 0
        self._step_losses: List[float] = []
        self._busy = 0.0
        self._hops_sent = self._bytes_sent = 0

    def _sim(self, units: float) -> None:
        if self.simulate_compute_s:
            time.sleep(units * self.simulate_compute_s)

    def _sync(self) -> None:
        """Close a hop's busy interval on the device's clock."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def set_generation(self, generation: int) -> int:
        """Stamp this stage with the pipeline's gang generation (set by
        the driver right after gang registration) — the tag every plane
        event row carries, so a timeline of a reshaped run separates
        the superseded pipeline's spans from its successor's."""
        self.generation = generation
        return generation

    def _boundary(self, direction: str, mb: int, nbytes: int) -> None:
        """The inter-stage hop edge: one failpoint site per direction
        (keyed by stage, so a schedule can target one stage's sends) and
        one plane-event row. drop/short/disconnect surface as a typed
        transport failure of the hop — the compiled chain propagates it
        to the driver's result ref, the step fails typed, and the caller
        retries the step (the activation rode the object plane, so a
        lost/truncated frame means the hop must re-run); ``kill`` is the
        chaos suite's mid-1F1B stage SIGKILL."""
        from .._private import failpoints
        from ..util import events

        if direction == "send":
            act = failpoints.fire("mpmd.boundary.send",
                                  key=f"s{self.stage_idx}")
        else:
            act = failpoints.fire("mpmd.boundary.recv",
                                  key=f"s{self.stage_idx}")
        if act in ("drop", "short", "disconnect"):
            raise failpoints.FailpointError(
                f"mpmd boundary {direction} {act} injected at stage "
                f"{self.stage_idx} (mb {mb}, seed {failpoints.seed()})")
        events.emit("pipe.stage.boundary", "pipe", stage=self.stage_idx,
                    mb=mb, gen=self.generation, dir=direction,
                    nbytes=nbytes)
        if direction == "send":
            self._hops_sent += 1
            self._bytes_sent += nbytes

    def _emit_hop(self, name: str, mb: int, dur: float) -> None:
        from ..util import events

        if name == "fwd":
            events.emit("pipe.stage.fwd", "pipe", dur=dur,
                        stage=self.stage_idx, mb=mb, gen=self.generation)
        else:
            events.emit("pipe.stage.bwd", "pipe", dur=dur,
                        stage=self.stage_idx, mb=mb, gen=self.generation)

    def _track_vjp(self, mb, value) -> None:
        self._vjps[mb] = value
        self._peak_vjps = max(self._peak_vjps, len(self._vjps))

    def _cast_wire(self, t: torch.Tensor) -> torch.Tensor:
        """An activation/cotangent as a host tensor for the hop,
        down-cast to ``transport_dtype`` when one is set."""
        t = t.detach()
        if self.transport_dtype is not None:
            t = t.to(self.transport_dtype)
        return t.cpu()

    def _cast_compute(self, t: torch.Tensor, like=None) -> torch.Tensor:
        """A received hop tensor, copied off its store view onto this
        stage's device, in the compute dtype (or ``like``)."""
        return t.to(self.device, like if like is not None
                    else self.cfg.dtype, copy=True)

    def _finish(self, name: str, mb: int, t0: float, units: float) -> None:
        self._sync()
        self._sim(units)
        dur = time.perf_counter() - t0
        self._busy += dur
        self._emit_hop(name, mb, dur)

    # ------------------------------------------------------ pipeline hops

    def fwd(self, packet):
        """First stage: tokens -> activation (its output saved per
        microbatch)."""
        t0 = time.perf_counter()
        mb, tokens, targets = packet
        out = stage_forward(self.params, tokens.to(self.device, copy=True),
                            self.cfg, first=True)
        self._track_vjp(mb, (out, None))
        wire = self._cast_wire(out)
        self._finish("fwd", mb, t0, 1)
        self._boundary("send", mb, _nbytes(wire))
        return (mb, wire, targets)

    def mid_fwd(self, packet):
        """Mid stage: activation -> activation (saved with its input, so
        backward can emit the upstream cotangent)."""
        t0 = time.perf_counter()
        mb, act, targets = packet
        self._boundary("recv", mb, _nbytes(act))
        x = self._cast_compute(act).requires_grad_(True)
        out = stage_forward(self.params, x, self.cfg, first=False)
        self._track_vjp(mb, (out, x))
        wire = self._cast_wire(out)
        self._finish("fwd", mb, t0, 1)
        self._boundary("send", mb, _nbytes(wire))
        return (mb, wire, targets)

    def loss_bwd(self, packet):
        """Last stage: activation -> loss; returns the activation
        cotangent for the upstream stage's backward."""
        t0 = time.perf_counter()
        mb, act, targets = packet
        self._boundary("recv", mb, _nbytes(act))
        x = self._cast_compute(act).requires_grad_(True)
        loss = stage_loss(self.params, x, targets.to(self.device, copy=True),
                          self.cfg, chunked_vocab=self.chunked_vocab)
        loss.backward()
        loss = float(loss)
        self._step_losses.append(loss)
        gact = self._cast_wire(x.grad)
        self._finish("bwd", mb, t0, 2)
        self._boundary("send", mb, _nbytes(gact))
        return (mb, gact, loss)

    def mid_bwd(self, packet):
        """Mid stage backward: finish the saved forward with the
        downstream cotangent (the param grads accumulate); emit the
        upstream cotangent."""
        t0 = time.perf_counter()
        mb, gact, loss = packet
        self._boundary("recv", mb, _nbytes(gact))
        out, x = self._vjps.pop(mb)
        torch.autograd.backward(out, self._cast_compute(gact, out.dtype))
        gact_up = self._cast_wire(x.grad)
        del out, x
        self._finish("bwd", mb, t0, 1)
        self._boundary("send", mb, _nbytes(gact_up))
        return (mb, gact_up, loss)

    def bwd(self, packet):
        """First stage: finish the saved forward with the cotangent from
        the next stage; passes the microbatch loss through to the
        driver."""
        t0 = time.perf_counter()
        mb, gact, loss = packet
        self._boundary("recv", mb, _nbytes(gact))
        out, _ = self._vjps.pop(mb)
        torch.autograd.backward(out, self._cast_compute(gact, out.dtype))
        del out
        self._finish("bwd", mb, t0, 1)
        return loss

    # -------------------------------------------------------- step control

    def _grads(self) -> List[torch.Tensor]:
        return [t.grad for t in _leaves(self.params) if t.grad is not None]

    def apply_gradients(self, completed: Optional[int] = None):
        """Average the accumulated grads (the microbatches' sum, in the
        parameters' dtype), step the local AdamW. ``completed``
        overrides the microbatch divisor for a partial step
        (drain-shortened schedule): the mean stays a mean over the
        microbatches that actually ran."""
        grads = self._grads()
        if not grads:
            return None
        scale = 1.0 / (completed if completed else self.n_microbatches)
        with torch.no_grad():
            for g in grads:
                g.mul_(scale)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        losses, self._step_losses = self._step_losses, []
        return float(np.mean(losses)) if losses else None

    def reset_step_state(self) -> bool:
        """Discard partial-step backward state (accumulated grads, saved
        VJPs, per-microbatch losses). The driver calls this on every
        stage when a step fails mid-schedule on a hop transport failure:
        the microbatches that completed before the fault must NOT be
        averaged into the retry's update."""
        self._vjps.clear()
        self.opt.zero_grad(set_to_none=True)
        self._step_losses = []
        return True

    def grad_norm(self):
        """Global norm of the accumulated (unscaled) grads over the
        microbatch count — parity checks read this before
        apply_gradients."""
        grads = self._grads()
        if not grads:
            return 0.0
        sq = sum(float(g.float().pow(2).sum()) for g in grads)
        return float(np.sqrt(sq)) / self.n_microbatches

    def take_busy(self) -> float:
        """Return and reset this stage's busy-seconds accumulator."""
        b, self._busy = self._busy, 0.0
        return b

    def live_vjp_count(self) -> int:
        return len(self._vjps)

    def peak_vjp_count(self) -> int:
        """High-water mark of concurrently-live VJPs (the per-stage
        activation-memory proxy: 1F1B bounds it by pipeline depth, GPipe
        lets it reach the microbatch count)."""
        p, self._peak_vjps = self._peak_vjps, len(self._vjps)
        return p

    def get_params(self):
        return _tree_map(_host_tensor, self.params)

    def pid(self) -> int:
        return os.getpid()

    def probe(self, reset: bool = False) -> dict:
        """What this stage's process holds and did: its pid, device and
        GPU ids, the peak memory allocated on its card, the flash
        kernels' launch counts, the hops it sent and their bytes, and each
        leaf's squared gradient norm (fp32, of the mean over microbatches)
        by path. ``reset`` sets the peak, the counts and the hop tally to
        0 after the reading."""
        from .sharding import tree_paths

        cuda = self.device.type == "cuda"
        m2 = float(self.n_microbatches) ** 2
        out = {"pid": os.getpid(), "device": str(self.device),
               "gpu_ids": ray_tpu_torch.get_gpu_ids(),
               "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                              if cuda else 0),
               "counts": {c: getattr(attention, c) for c in _COUNTS},
               "hops_sent": self._hops_sent,
               "bytes_sent": self._bytes_sent,
               "grad_sq": {path: float(t.grad.float().square().sum()) / m2
                           for path, t in tree_paths(self.params)
                           if t.grad is not None}}
        if reset:
            for c in _COUNTS:
                setattr(attention, c, 0)
            if cuda:
                torch.cuda.reset_peak_memory_stats(self.device)
            self._hops_sent = self._bytes_sent = 0
        return out


def stage_placement(device: torch.device, n_stages: int, n_gpus: float,
                    stage_options: Optional[List[dict]] = None
                    ) -> List[dict]:
    """Each stage actor's options for ``device``, over ``stage_options``.
    On CUDA a stage that names no ``num_gpus`` holds a card, or, where the
    cluster's ``n_gpus`` cards are fewer than the stages, an equal share
    of one; a CUDA pipeline on a cluster with no card, or a stage that
    holds no GPU on CUDA or one on the CPU, raises."""
    opts = [dict(o) for o in (stage_options or [{}] * n_stages)]
    if device.type != "cuda":
        if any(o.get("num_gpus") for o in opts):
            raise ValueError(f"a stage holds a GPU on device {device}")
        return opts
    if n_gpus < 1:
        raise RuntimeError(
            "the pipeline runs its stages on CUDA by default and the "
            "cluster has no GPU; pass device='cpu' to run them on the CPU")
    share = 1.0 / math.ceil(n_stages / int(n_gpus))
    for o in opts:
        o.setdefault("num_gpus", share)
        if not o["num_gpus"]:
            raise ValueError("a stage holds no GPU on device cuda")
    return opts


class MPMDPipeline:
    """Driver handle: an N-stage cross-process pipeline-parallel trainer.

    ``step(tokens)`` runs one pipelined step: microbatches stream through
    the compiled actor chain (fwd hops forward, cotangent hops backward),
    each stage accumulates grads, then every stage applies its optimizer.

    ``schedule``:
      * ``"1f1b"`` (default) — at most ``n_stages`` microbatches in
        flight; per-stage live VJPs are bounded by pipeline depth.
      * ``"gpipe"`` — all microbatches stream at once (max overlap, peak
        memory ∝ microbatch count).

    ``transport_dtype="bfloat16"`` down-casts activations AND cotangents
    for the inter-stage hop (half the bytes; compute stays in
    ``cfg.dtype``).

    ``device`` is where the stages run: CUDA unless the caller names
    another (``"cpu"``, as the tests do). On CUDA each stage holds a card,
    or a share of one where the cluster has fewer cards than stages
    (``stage_placement``); a stage never runs on the CPU in its place.
    ``stage_options`` are each stage actor's options, over those defaults
    (``num_gpus=0.5`` pins two stages to one card).

    After each ``step()``/``grad_check_step()``, ``last_step_stats`` holds
    ``{"wall_s", "stage_busy_s", "bubble_fraction"}`` where
    bubble_fraction = 1 − mean(stage busy)/wall — the pipeline-bubble
    measure the schedule is trying to minimize.
    """

    def __init__(self, cfg, params: Dict[str, Any], *, n_stages: int = 2,
                 n_microbatches: int = 2, lr: float = 1e-3,
                 max_inflight: Optional[int] = None,
                 schedule: str = "1f1b",
                 transport_dtype: Optional[str] = None,
                 simulate_compute_s: Optional[float] = None,
                 drain_aware: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 stage_options: Optional[List[dict]] = None,
                 gang_name: Optional[str] = None,
                 stage_env: Optional[Dict[str, str]] = None,
                 chunked_vocab: int = 0, device=None):
        import cloudpickle

        if schedule not in ("1f1b", "gpipe"):
            raise ValueError(f"unknown schedule {schedule!r}")
        stage_options = stage_placement(
            resolve_device(device), n_stages,
            ray_tpu_torch.cluster_resources().get("GPU", 0.0), stage_options)
        self.cfg = cfg
        self.n_stages = n_stages
        self.n_microbatches = n_microbatches
        self.schedule = schedule
        self.lr = lr
        self.transport_dtype = transport_dtype
        self.simulate_compute_s = simulate_compute_s
        self.drain_aware = drain_aware
        self.checkpoint_dir = checkpoint_dir
        self.gang_name = gang_name
        self.generation = 0
        self.chunked_vocab = chunked_vocab
        self.last_step_stats: Optional[dict] = None
        self.last_checkpoint: Optional[str] = None
        self._drain_evt = threading.Event()
        self._drain_info: Optional[dict] = None
        self._drain_sub = None
        self._member_lost_evt = threading.Event()
        self._member_lost_info: Optional[dict] = None
        self._gang_sub = None
        stage_params = split_llama_params(_tree_map(_host_tensor, params),
                                          n_stages)
        cfg_blob = cloudpickle.dumps(cfg)
        # Per-stage actor options (resources=... pins a stage to a node —
        # the drain tests pin a stage to the node they then drain;
        # num_gpus pins it to a card).
        self.stages = [
            PipelineStageActor.options(**stage_options[i]).remote(
                i, n_stages, cfg_blob, stage_params[i],
                lr, n_microbatches, transport_dtype, simulate_compute_s,
                stage_env, chunked_vocab)
            for i in range(n_stages)
        ]
        del stage_params
        # Formation wrap (the WorkerGroup discipline): everything past
        # the stage spawns must not leak on failure — a gang
        # registration or chain-compile error would strand the stage
        # actors (and a registered gang record) until driver exit.
        try:
            if gang_name:
                self._register_gang()
                self._start_member_watcher()
            from ..dag import InputNode

            with InputNode() as inp:
                node = self.stages[0].fwd.bind(inp)
                for s in self.stages[1:-1]:
                    node = s.mid_fwd.bind(node)
                node = self.stages[-1].loss_bwd.bind(node)
                for s in reversed(self.stages[1:-1]):
                    node = s.mid_bwd.bind(node)
                dag = self.stages[0].bwd.bind(node)
            if max_inflight is None:
                # 1F1B: admit at most `depth` microbatches — a new
                # forward enters only when a backward completes, so each
                # stage holds ≤ n_stages live VJPs. GPipe: the whole
                # schedule at once.
                max_inflight = (n_stages if schedule == "1f1b"
                                else n_microbatches + 2)
            self._dag = dag.experimental_compile(max_inflight=max_inflight)
        except Exception:
            self._deregister_gang()
            for s in self.stages:
                try:
                    ray_tpu_torch.kill(s)
                except Exception:
                    pass
            raise
        if drain_aware:
            self._start_drain_watcher()

    # ---------------------------------------------------- gang fault plane

    def _register_gang(self):
        """Register the stage actors as a gang (rank == stage index):
        the GCS turns any stage-process death into a ``member_lost``
        push, and the returned strictly-monotonic generation stamps this
        pipeline incarnation — a re-form under the same name after a
        SIGKILL lands at generation+1."""
        from .._private.worker import global_worker

        reply = global_worker().request_gcs(  # raylint: disable=RTL161 (teardown deregisters; driver-exit GC is the backstop)
            {"t": "gang_register", "name": self.gang_name,
             "members": [s._id.binary() for s in self.stages]},
            timeout=30)
        if not reply.get("ok"):
            raise RuntimeError(
                f"pipeline gang registration failed: {reply.get('err')}")
        self.generation = int(reply["generation"])
        ray_tpu_torch.get([s.set_generation.remote(self.generation)
                           for s in self.stages], timeout=60)

    def _start_member_watcher(self):
        """One thread on the gang channel: a ``member_lost`` push for
        THIS generation arms the event the admission/result loops poll —
        a stage SIGKILL mid-1F1B surfaces as a typed
        :class:`PipelineMemberLost` within one poll tick, not the
        compiled chain's result timeout."""

        def watch():
            from ..util.pubsub import Subscriber

            try:
                sub = Subscriber(f"gang:{self.gang_name}")
            except Exception:
                # A dead push channel silently demotes stage-loss
                # detection to the 300 s result timeout — say so.
                logger.warning(
                    "pipeline gang watcher for %r could not subscribe: "
                    "member-loss detection falls back to the result "
                    "timeout", self.gang_name, exc_info=True)
                return
            self._gang_sub = sub
            for item in sub:
                m = item.get("message") or {}
                if (m.get("event") != "member_lost"
                        or m.get("generation") != self.generation):
                    continue
                self._member_lost_info = m
                self._member_lost_evt.set()

        threading.Thread(target=watch, daemon=True,
                         name=f"mpmd-gang-watch-{self.gang_name}").start()

    def _deregister_gang(self):
        if not self.gang_name or not self.generation:
            return
        from .._private.worker import global_worker

        try:
            global_worker().request_gcs(
                {"t": "gang_deregister", "name": self.gang_name,
                 "generation": self.generation}, timeout=10)
        except Exception:
            pass  # GCS down / already gone — driver-exit GC covers it

    def _check_member_lost(self):
        if not self._member_lost_evt.is_set():
            return
        info = self._member_lost_info or {}
        raise PipelineMemberLost(
            info.get("lost_ranks") or [], self.n_stages,
            generation=self.generation,
            cause=f"membership push: {info.get('cause', 'member lost')}",
            checkpoint_path=self.last_checkpoint)

    # --------------------------------------------------- drain fault plane

    def _stages_on_nodes(self, node_ids) -> List[int]:
        from ..util import state as state_api

        try:
            actors = {a["actor_id"]: a.get("node_id")
                      for a in state_api.list_actors(limit=100000)}
        except Exception:
            return []
        return [i for i, s in enumerate(self.stages)
                if actors.get(s._id.hex()) in node_ids]

    def _start_drain_watcher(self):
        """One thread on the ``node_events`` channel: a node_draining
        event naming a node that hosts a stage arms the drain flag the
        admission loop checks at every microbatch boundary. A node
        already DRAINING at watcher start (the subscribe/publish race)
        is picked up by the initial probe."""

        def watch():
            from ..util import state as state_api
            from ..util.pubsub import Subscriber

            try:
                sub = Subscriber("node_events")
            except Exception:
                return
            self._drain_sub = sub
            try:
                draining = {n["node_id"] for n in state_api.list_nodes()
                            if n.get("draining") and n.get("alive")}
            except Exception:
                draining = set()
            if draining:
                self._arm_drain(draining, "already draining at start")
            for item in sub:
                m = item.get("message") or {}
                if m.get("event") != "node_draining":
                    continue
                self._arm_drain({m.get("node_id")},
                                str(m.get("reason") or "drain notice"))

        threading.Thread(target=watch, daemon=True,
                         name="mpmd-drain-watch").start()

    def _arm_drain(self, node_ids, reason: str):
        if self._drain_evt.is_set():
            return
        stages = self._stages_on_nodes(set(node_ids))
        if not stages:
            return
        self._drain_info = {"stages": stages, "reason": reason,
                            "node_ids": sorted(n for n in node_ids if n)}
        self._drain_evt.set()

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Gather every stage's params (a DRAINING node is still alive —
        this is exactly the window the drain deadline grants), merge to
        the full tree, persist through ``train.save_pytree``. Returns the
        checkpoint path."""
        import json
        import tempfile

        from ..train.checkpoint import save_pytree

        merged = merge_stage_params(self.get_params())
        path = path or self.checkpoint_dir or tempfile.mkdtemp(
            prefix="mpmd_ckpt_")
        save_pytree(merged, path)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"n_stages": self.n_stages,
                       "n_microbatches": self.n_microbatches,
                       "n_layers": len(merged["layers"]),
                       "generation": self.generation,
                       "ts": time.time()}, f)
        self.last_checkpoint = path
        return path

    @classmethod
    def from_checkpoint(cls, path: str, cfg, *, n_stages: int,
                        **kwargs) -> "MPMDPipeline":
        """Reshape from a merged checkpoint: re-split the params at a NEW
        stage count (typically fewer — the surviving nodes) and rebuild
        the actor chain. Placement excludes draining nodes, so the
        reshaped pipeline lands clear of the doomed hardware."""
        from ..train.checkpoint import load_pytree

        return cls(cfg, load_pytree(path, device="cpu"), n_stages=n_stages,
                   **kwargs)

    def _run_microbatches(self, tokens: torch.Tensor,
                          targets: torch.Tensor) -> List[float]:
        """Stream microbatches through the compiled chain. Admission is
        the drain boundary: ``execute`` blocks while the pipe is full
        (1F1B), so between any two admissions a backward has completed —
        checking the drain flag here stops the schedule at a microbatch
        boundary with every in-flight microbatch finishing its full
        forward+backward before control returns. Both the admission and
        the result waits poll in short slices so a gang ``member_lost``
        push (a stage SIGKILLed mid-1F1B) fails the step typed within
        one tick — a dead stage must never be discovered by waiting out
        the flat result timeout, and never wedge admission against a
        ``max_inflight`` window that can no longer drain."""
        import concurrent.futures

        from .._private import failpoints
        from ..dag.compiled import AdmissionTimeout

        m = self.n_microbatches
        if tokens.shape[0] % m != 0:
            raise ValueError(
                f"batch {tokens.shape[0]} not divisible by "
                f"{m} microbatches")
        tok_mb = torch.chunk(tokens, m)
        tgt_mb = torch.chunk(targets, m)
        t0 = time.perf_counter()
        refs = []
        stopped = False
        for i in range(m):
            if self.drain_aware and self._drain_evt.is_set():
                break
            self._check_member_lost()
            failpoints.fire("mpmd.admit", key=f"g{self.generation}")
            while True:
                try:
                    refs.append(self._dag.execute(
                        (i, tok_mb[i], tgt_mb[i]), timeout=0.5))
                    break
                except AdmissionTimeout:
                    # Pipe full: between polls a backward normally
                    # completes; if instead a stage died, the loss push
                    # unwedges us here — and a drain notice that lands
                    # while we WAIT for a slot stops the schedule at
                    # this boundary (the microbatch was never admitted,
                    # so in-flight ones still finish their full
                    # forward+backward).
                    self._check_member_lost()
                    if self.drain_aware and self._drain_evt.is_set():
                        stopped = True
                        break
            if stopped:
                break
        losses = []
        for r in refs:
            deadline = time.monotonic() + 300
            while True:
                try:
                    losses.append(r.get(timeout=0.5))
                    break
                except concurrent.futures.TimeoutError:
                    self._check_member_lost()
                    if time.monotonic() >= deadline:
                        raise
        wall = time.perf_counter() - t0
        busy = ray_tpu_torch.get([s.take_busy.remote() for s in self.stages],
                                 timeout=300)
        self.last_step_stats = {
            "wall_s": wall, "stage_busy_s": busy,
            "completed_microbatches": len(refs),
            "bubble_fraction": max(0.0, 1.0 - (sum(busy) / len(busy))
                                   / max(wall, 1e-9)),
        }
        return losses

    def _reset_step_state(self):
        """Best-effort stage-state reset after a mid-schedule hop
        failure: the typed error propagates to the caller, whose RETRY
        must start from clean per-stage accumulators (the completed
        microbatches of the failed step would otherwise be averaged
        into the retry's update — silent gradient corruption)."""
        try:
            ray_tpu_torch.get([s.reset_step_state.remote()
                               for s in self.stages], timeout=60)
        except Exception:
            pass  # a dead/unreachable stage: the caller is re-forming

    def _run_microbatches_clean(self, tokens, targets) -> List[float]:
        """`_run_microbatches` with the retry contract: any failure
        OTHER than a member loss (whose stages are dead or about to be
        torn down) leaves the surviving stages' step state clean."""
        try:
            return self._run_microbatches(tokens, targets)
        except PipelineMemberLost:
            raise
        except Exception:
            self._reset_step_state()
            raise

    @staticmethod
    def _batch(tokens, targets=None):
        tokens = _host_tensor(tokens).long()
        if targets is None:
            targets = llama.next_token_targets(tokens)
        return tokens, _host_tensor(targets).long()

    def step(self, tokens, targets=None) -> float:
        """One pipelined AdamW step on ``tokens`` [B, L] (a tensor or an
        array); returns the mean microbatch loss."""
        tokens, targets = self._batch(tokens, targets)
        losses = self._run_microbatches_clean(tokens, targets)
        k = len(losses)
        if k:
            ray_tpu_torch.get([s.apply_gradients.remote(
                completed=k if k < self.n_microbatches else None)
                for s in self.stages], timeout=300)
        if self.drain_aware and self._drain_evt.is_set():
            info = self._drain_info or {}
            ckpt = self.save_checkpoint()
            raise PipelineDrainSignal(
                ckpt, k, self.n_microbatches,
                info.get("stages", []), info.get("reason", ""))
        return float(np.mean(losses))

    def grad_check_step(self, tokens) -> float:
        """Run forward+backward WITHOUT the optimizer step; returns the
        mean loss (grad state stays accumulated for ``grad_norms``)."""
        tokens, targets = self._batch(tokens)
        return float(np.mean(self._run_microbatches_clean(tokens, targets)))

    def grad_norms(self) -> List[float]:
        return ray_tpu_torch.get(
            [s.grad_norm.remote() for s in self.stages], timeout=300)

    def live_vjp_counts(self) -> List[int]:
        return ray_tpu_torch.get(
            [s.live_vjp_count.remote() for s in self.stages], timeout=300)

    def peak_vjp_counts(self) -> List[int]:
        """Per-stage high-water marks of live VJPs since last read — the
        activation-memory proxy that separates 1F1B (≤ depth) from GPipe
        (up to the microbatch count)."""
        return ray_tpu_torch.get(
            [s.peak_vjp_count.remote() for s in self.stages], timeout=300)

    def analytic_bubble_fraction(self) -> float:
        """(p-1)/(m+p-1) — the textbook non-interleaved pipeline bubble
        for p stages and m microbatches."""
        p, m = self.n_stages, self.n_microbatches
        return (p - 1) / (m + p - 1)

    def get_params(self) -> List[Dict[str, Any]]:
        return ray_tpu_torch.get(
            [s.get_params.remote() for s in self.stages], timeout=300)

    def teardown(self):
        # Deregister FIRST: the orchestrated stage kills below must not
        # publish member_lost storms to survivors of the same gang name.
        self._deregister_gang()
        for sub in (self._drain_sub, self._gang_sub):
            if sub is not None:
                try:
                    sub.close()
                except Exception:
                    pass
        try:
            self._dag.teardown()
        except Exception:
            pass
        for s in self.stages:
            try:
                ray_tpu_torch.kill(s)
            except Exception:
                pass


def _stage_layers(n_layers: int, n_stages: int, stage_idx: int) -> int:
    """Stage ``stage_idx``'s layer count; one stage holds them all."""
    if n_stages == 1 and stage_idx == 0:
        return n_layers
    return stage_layer_counts(n_layers, n_stages)[stage_idx]


def stage_param_count(cfg, n_stages: int, stage_idx: int) -> int:
    """The parameter count of stage ``stage_idx`` of
    :func:`split_llama_params`' split (the embedding on stage 0, the norm
    and ``lm_head`` on the last). ``n_stages=1`` is the whole model as one
    program."""
    d, f = cfg.d_model, cfg.d_ff
    kvdim = cfg.n_kv_heads * cfg.head_dim
    per_layer = (d * cfg.n_heads * cfg.head_dim + 2 * d * kvdim
                 + cfg.n_heads * cfg.head_dim * d + 3 * d * f + 2 * d)
    n = _stage_layers(cfg.n_layers, n_stages, stage_idx) * per_layer
    if stage_idx == 0:
        n += cfg.vocab_size * d
    if stage_idx == n_stages - 1:
        n += d * cfg.vocab_size + d
    return n


def stage_hbm_budget(cfg, n_stages: int, stage_idx: int, *,
                     devices_per_stage: int, batch_per_chip: int,
                     seq: int, n_microbatches: int, hbm_gib_per_chip: float,
                     chunk_v: int = 16384, schedule: str = "1f1b") -> dict:
    """The device memory one device of stage ``stage_idx`` needs, in
    bytes, with the stage's state split over its ``devices_per_stage``
    (FSDP): bf16 parameters and gradients, fp32 Adam moments, the live
    microbatches' activations at the schedule's depth (non-interleaved
    1F1B: stage i holds up to ``min(p - i, m)`` microbatches, each its
    remat boundaries and its inbound activation; ``"gpipe"``: all m), one
    layer's recompute working set, the boundary's send and receive
    buffers, two gathered layers, and on the first and last stages the
    embedding rows and the chunked loss. ``live_mb_bound`` (``min(p, m)``
    under 1F1B) gives the worst case. ``hbm_gib_per_chip`` is the device's
    memory, which the caller states. ``n_stages=1`` budgets the whole model
    as one FSDP program: the first and the last stage at once, with no
    boundary to send over."""
    d, f = cfg.d_model, cfg.d_ff
    kvdim = cfg.n_kv_heads * cfg.head_dim
    D = devices_per_stage
    bl = batch_per_chip * seq
    n_layers_stage = _stage_layers(cfg.n_layers, n_stages, stage_idx)
    per_layer_params = (d * cfg.n_heads * cfg.head_dim + 2 * d * kvdim
                        + cfg.n_heads * cfg.head_dim * d + 3 * d * f
                        + 2 * d)
    n_stage = stage_param_count(cfg, n_stages, stage_idx)
    first = stage_idx == 0
    last = stage_idx == n_stages - 1
    m, p = n_microbatches, n_stages
    depth = min(p - stage_idx, m) if schedule == "1f1b" else m
    live_bound = min(p, m) if schedule == "1f1b" else m
    # the backward state each live microbatch pins on this stage
    per_live_mb = (bl * d * 2 * n_layers_stage            # remat boundaries
                   + (0 if first else bl * d * 2))        # inbound act
    rows = {
        "params_bf16": 2 * n_stage / D,
        "grads_bf16": 2 * n_stage / D,
        "adam_m_fp32": 4 * n_stage / D,
        "adam_v_fp32": 4 * n_stage / D,
        "live_mb_state_bf16_x_depth": depth * per_live_mb,
        "recompute_working_set_bf16": bl * (4 * d + 3 * f + 2 * kvdim) * 2,
        "boundary_send_recv_bf16": 2 * bl * d * 2,
        "allgather_layers_bf16_x2": 2 * per_layer_params * 2,
    }
    if n_stages == 1:
        del rows["boundary_send_recv_bf16"]
    if first:
        rows["embed_rows_bf16"] = bl * d * 2
    if last:
        # one fp32 logits chunk, the fp32 hidden states and the whole head
        rows["xent_chunk_fp32"] = bl * chunk_v * 4
        rows["xent_hidden_fp32"] = bl * d * 4
        rows["allgather_vocab_head_bf16"] = cfg.vocab_size * d * 2
    total = sum(rows.values())
    worst = total + (live_bound - depth) * per_live_mb
    return {
        "stage": stage_idx,
        "n_layers": n_layers_stage,
        "devices": D,
        "stage_param_count": n_stage,
        "batch_per_chip": batch_per_chip,
        "seq": seq,
        "schedule": schedule,
        "depth_1f1b": depth,
        "live_mb_bound": live_bound,
        "bytes_per_chip": {k: int(v) for k, v in rows.items()},
        "gib_per_chip": {k: round(v / 2**30, 3) for k, v in rows.items()},
        "total_gib_per_chip": round(total / 2**30, 2),
        "worst_case_gib_per_chip": round(worst / 2**30, 2),
        "hbm_gib_per_chip": hbm_gib_per_chip,
        "fits": worst / 2**30 < hbm_gib_per_chip,
        "headroom_gib": round(hbm_gib_per_chip - worst / 2**30, 2),
    }


#: Elements an :class:`AdamW` update takes at a time: its fp32 temporaries
#: stay near 256 MiB however large the leaf (an 8B stage's embedding has
#: 525 M elements).
ADAM_SLICE = 1 << 26


class AdamW:
    """The reference's ``optax.adamw(lr, weight_decay=0.1,
    mu_dtype=float32)`` over a list of leaves, each updated in place with
    its ``.grad``, in optax's order and dtypes:

      mu <- (1 - b1) g + b1 mu     held in fp32
      nu <- (1 - b2) g^2 + b2 nu   held in the leaf's dtype
      u  <- mu / (1 - b1^t) / (sqrt(nu / (1 - b2^t)) + eps) + wd p
      p  <- p - lr u, rounded once to p's dtype

    at optax's b1, b2 and eps, with one int32 step count t for the tree
    (optax's ``count``) and the bias corrections in fp32, cast to each
    moment's dtype. A Python scalar takes the dtype of the tensor it
    scales, as JAX's weakly typed scalars do. The moments are allocated
    here, as ``opt.init`` does. The update is elementwise, so it walks
    each leaf in slices of ``ADAM_SLICE`` elements and its temporaries
    stay small beside an 8B stage's state."""

    b1, b2, eps, weight_decay = 0.9, 0.999, 1e-8, 0.1

    def __init__(self, leaves: List[torch.Tensor], lr: float):
        self.leaves = list(leaves)
        self.lr = lr
        device = self.leaves[0].device if self.leaves else None
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.leaves]
        self.nu = [torch.zeros_like(p) for p in self.leaves]

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1
        bc1 = 1 - torch.pow(self.b1, self.count)    # fp32, as optax's
        bc2 = 1 - torch.pow(self.b2, self.count)
        consts: Dict[Any, torch.Tensor] = {}

        def c(x, like):
            key = (x, like.dtype)
            if key not in consts:
                consts[key] = torch.tensor(x, dtype=like.dtype,
                                           device=like.device)
            return consts[key]

        for p, mu, nu in zip(self.leaves, self.mu, self.nu):
            # a leaf the loss left out steps on a zero gradient, as in optax
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            flat = [t.view(-1) for t in (p, g, mu, nu)]
            for a in range(0, p.numel(), ADAM_SLICE):
                ps, gs, m, v = (t[a:a + ADAM_SLICE] for t in flat)
                m.copy_(c(1 - self.b1, gs) * gs + c(self.b1, m) * m)
                v.copy_(c(1 - self.b2, gs) * gs.square() + c(self.b2, v) * v)
                u = (m / bc1.to(m.dtype)) / (
                    (v / bc2.to(v.dtype)).sqrt() + c(self.eps, v))
                u = u + c(self.weight_decay, ps) * ps
                ps.copy_(ps + c(-self.lr, u) * u)

    def zero_grad(self) -> None:
        for p in self.leaves:
            p.grad = None


def build_stage_step(cfg, stage_idx: int, n_stages: int, *,
                     lr: float = 3e-4, chunked_vocab: int = 0):
    """One pp-stage's per-microbatch compute as one plain step: the
    stage's forward, its full backward, and an AdamW update of its
    params in place (the actor path splits forward and backward around
    the 1F1B schedule with a saved forward; this runs the same math and
    holds the same resident state as one unit).

    Returns ``(make_opt, step_fn, kind)``. ``make_opt(params)`` builds the
    stage's :class:`AdamW`, the reference's ``optax.adamw(lr,
    weight_decay=0.1, mu_dtype=float32)``: the first moment in fp32, the
    second in the parameters' dtype. ``kind`` names the step's signature:

      * ``"first"``: ``step_fn(params, opt, tokens[B,L], g_out[B,L,D])``
        → ``out``
      * ``"mid"``:   ``step_fn(params, opt, act[B,L,D], g_out[B,L,D])``
        → ``(out, g_act)``
      * ``"last"``:  ``step_fn(params, opt, act[B,L,D], targets[B,L])``
        → ``(loss, g_act)``

    ``params`` is the stage's tree (``split_llama_params``), its leaves
    requiring gradients; the step leaves their ``.grad`` cleared.
    """
    from ..models.convert import trainable

    def make_opt(params):
        return AdamW(trainable(params), lr)

    def update(opt):
        opt.step()
        opt.zero_grad()

    if stage_idx == n_stages - 1:
        def step_fn(params, opt, act, targets):
            act = act.detach().requires_grad_(True)
            loss = stage_loss(params, act, targets, cfg,
                              chunked_vocab=chunked_vocab)
            loss.backward()
            update(opt)
            return loss.detach(), act.grad
        return make_opt, step_fn, "last"

    if stage_idx == 0:
        def step_fn(params, opt, tokens, g_out):
            out = stage_forward(params, tokens, cfg, first=True)
            out.backward(g_out.to(out.dtype))
            update(opt)
            return out.detach()
        return make_opt, step_fn, "first"

    def step_fn(params, opt, act, g_out):
        act = act.detach().requires_grad_(True)
        out = stage_forward(params, act, cfg, first=False)
        out.backward(g_out.to(out.dtype))
        update(opt)
        return out.detach(), act.grad
    return make_opt, step_fn, "mid"


# --------------------------------------------------------------------------
# The 8B certificate's machinery (the reference's pp x fsdp lowering): each
# stage of a multi-host pipeline is its own FSDP program over its own ranks
# (``sharding.stage_submesh``). Eager PyTorch has no ahead-of-time compile:
# a stage's step is run once on ``meta`` tensors at the full geometry,
# which checks that its forward, backward and optimizer state hold
# together, and each rank's bytes follow from the specs ``LLAMA_RULES``
# give on the stage's mesh.


def stage_abstract_params(cfg, n_stages: int) -> List[Dict[str, Any]]:
    """Per-stage parameter trees of the full geometry on ``meta`` tensors
    (shapes and dtypes, nothing allocated): ``split_llama_params`` of
    ``init_params``' tree, the reference's ``jax.eval_shape`` tree."""
    full = llama.init_params(cfg, None, device="meta")
    return split_llama_params(full, n_stages)


@dataclasses.dataclass(frozen=True)
class StageStepLowering:
    """What :func:`lower_stage_step` traced: the stage's kind, its step's
    outputs (``meta`` tensors) and one rank's bytes, under the names of
    the reference's ``Lowered.compile().memory_analysis()``: the arguments
    (parameter shards, the fp32 first moment, the second moment, the step
    count, the step's inputs) and the outputs (the same state after the
    update and the step's results). ``by_class`` breaks both down."""

    kind: str
    outputs: tuple
    argument_size_in_bytes: int
    output_size_in_bytes: int
    by_class: Dict[str, int]


def _rank_bytes(t: torch.Tensor, spec, mesh) -> int:
    """The bytes of one rank's block of ``t`` split by ``spec`` over
    ``mesh`` (a dim that does not divide takes the larger block)."""
    from .sharding import _axes

    n = t.element_size()
    for i, dim in enumerate(t.shape):
        entry = spec[i] if i < len(spec) else None
        ways = math.prod(mesh.shape[a] for a in _axes(entry))
        n *= -(-dim // ways)
    return n


def lower_stage_step(cfg, stage_idx: int, n_stages: int, mesh, *,
                     batch: int, seq: int, lr: float = 3e-4,
                     chunked_vocab: int = 0) -> StageStepLowering:
    """Stage ``stage_idx``'s step (``build_stage_step``) at the full
    geometry against its FSDP submesh ``mesh`` (``stage_submesh``), the
    reference's ahead-of-time lowering. The step runs once on ``meta``
    tensors: the stage's parameters (:func:`stage_abstract_params`), its
    AdamW state, and a global batch of ``batch`` rows of ``seq`` tokens.
    Each rank's bytes follow from the specs: the parameters by
    ``LLAMA_RULES`` (``shardings_for_tree``), each moment as its
    parameter, the count whole, the activations, cotangents and tokens
    split over the batch (``activation_sharding``), the loss whole."""
    from .sharding import activation_sharding, shardings_for_tree, tree_paths

    make_opt, step_fn, kind = build_stage_step(
        cfg, stage_idx, n_stages, lr=lr, chunked_vocab=chunked_vocab)
    params = stage_abstract_params(cfg, n_stages)[stage_idx]
    specs = [spec for _, spec in tree_paths(shardings_for_tree(params,
                                                               mesh))]
    opt = make_opt(params)
    meta = torch.device("meta")
    act = torch.empty(batch, seq, cfg.d_model, dtype=cfg.dtype, device=meta)
    ints = torch.empty(batch, seq, dtype=torch.int32, device=meta)
    inputs = {"first": (ints, act), "mid": (act, act),
              "last": (act, ints)}[kind]
    act_spec = activation_sharding(mesh)

    def state_bytes() -> Dict[str, int]:
        return {
            "params": sum(_rank_bytes(p, s, mesh)
                          for p, s in zip(opt.leaves, specs)),
            "adam_mu": sum(_rank_bytes(m, s, mesh)
                           for m, s in zip(opt.mu, specs)),
            "adam_nu": sum(_rank_bytes(v, s, mesh)
                           for v, s in zip(opt.nu, specs)),
            "count": _rank_bytes(opt.count, (), mesh),
        }

    def io_bytes(ts) -> int:
        return sum(_rank_bytes(t, act_spec[:t.dim()], mesh) for t in ts)

    before = state_bytes()
    out = step_fn(params, opt, *inputs)
    out = out if isinstance(out, tuple) else (out,)
    after = state_bytes()
    by_class = {**{f"in_{k}": v for k, v in before.items()},
                "in_inputs": io_bytes(inputs),
                **{f"out_{k}": v for k, v in after.items()},
                "out_results": io_bytes(out)}
    return StageStepLowering(
        kind, out,
        argument_size_in_bytes=sum(v for k, v in by_class.items()
                                   if k.startswith("in_")),
        output_size_in_bytes=sum(v for k, v in by_class.items()
                                 if k.startswith("out_")),
        by_class=by_class)
