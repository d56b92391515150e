"""The MPMD pipeline's stage math: a Llama tree split into stages, each
stage's forward and the last stage's loss, and each stage's parameter
count and memory budget.

Port of the JAX-free half of ``ray_tpu/parallel/mpmd_pipeline.py``
(``merge_stage_params``, ``stage_layer_counts``, ``split_llama_params``,
``stage_forward``, ``stage_loss``, ``stage_param_count``,
``stage_hbm_budget``), with its names. There each stage is an actor that
runs its own program and passes activations and their cotangents to the
next stage's actor; the stage math here is what such an actor computes.

Not ported yet: ``PipelineStageActor``, ``MPMDPipeline`` and their gang
and drain fault plane, which are built on the runtime's actors, compiled
DAGs and GCS; they wait for the gang fault plane (``ROADMAP.md`` A9).
The single-program pipeline over the ``pp`` axis is ``parallel.pipeline``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from ..models import llama
from ..ops.attention import flash_attention
from ..ops.chunked_xent import chunked_cross_entropy
from ..ops.layers import cross_entropy_loss, rms_norm, rope_frequencies
from ..ops.quant import mm


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


def stage_param_count(cfg, n_stages: int, stage_idx: int) -> int:
    """The parameter count of stage ``stage_idx`` of
    :func:`split_llama_params`' split (the embedding on stage 0, the norm
    and ``lm_head`` on the last)."""
    d, f = cfg.d_model, cfg.d_ff
    kvdim = cfg.n_kv_heads * cfg.head_dim
    per_layer = (d * cfg.n_heads * cfg.head_dim + 2 * d * kvdim
                 + cfg.n_heads * cfg.head_dim * d + 3 * d * f + 2 * d)
    n = stage_layer_counts(cfg.n_layers, n_stages)[stage_idx] * per_layer
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
    memory, which the caller states."""
    d, f = cfg.d_model, cfg.d_ff
    kvdim = cfg.n_kv_heads * cfg.head_dim
    D = devices_per_stage
    bl = batch_per_chip * seq
    n_layers_stage = stage_layer_counts(cfg.n_layers, n_stages)[stage_idx]
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
