"""Pipeline parallelism: JAX's SPMD GPipe schedule over the ``pp`` axis.

Port of ``ray_tpu/parallel/pipeline.py``, with its names. The layers are
stacked (``stack_layers``: each leaf gains a leading layer axis) and the
stacked axis is split over ``pp`` (``pipeline_shardings``), so a stage
holds ``n_layers / pp`` consecutive layers. M microbatches cross S stages
in M + S - 1 ticks; the bubble is (S - 1) / (M + S - 1) of them.

JAX runs the schedule as one SPMD program: every stage computes on every
tick, and the stage index enters only through ``jnp.where``. Here each
rank builds its own autograd graph, and the graphs must hold the same
collectives in the same order, or one rank's backward waits on a hop that
another never makes. So the port keeps JAX's form: every stage runs its
layers on every tick, the bubble's included (on zeros, or on the last
microbatch again); the stage index selects through ``torch.where`` on
tensors; and the hop to the next stage is ``collectives.rotate``, whose
gradient is the hop back. Skipping the bubble's compute would make the
ranks' graphs differ.

Around the pipeline the embedding, final norm, head and loss run on every
``pp`` rank (``make_pipelined_loss``, on ``training.loss_share``'s batch
split and share). The activations enter on stage 0 only and leave from the
last stage only: ``collectives.allreduce_bwd`` where they enter sums the
embedding's gradient over ``pp``, and ``allreduce_fwd`` where they leave
(a sum of the last stage's outputs and zeros, exact) passes the gradient
through once. Inside a stage, tensor parallelism is Megatron's
(``Placement.enter``/``leave``), and a stage's FSDP leaves are gathered
once a step, before the ticks, as JAX's shard_map boundary gathers them;
their gradient is reduce-scattered once.

On a one-device mesh (no process group) the S stages run in turn on each
tick on the whole stacked tree, and the hop is a turn of a list, as the
ring's ``sp`` ranks run in lockstep.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..models import llama
from ..ops.layers import rope_frequencies
from .collectives import allreduce_bwd, allreduce_fwd, rotate
from .mesh import Mesh
from .sharding import (LLAMA_RULES, _map, clean_spec, shardings_for_tree,
                       spec_for, tree_paths)
from .training import loss_share


def stack_layers(layers: Sequence[Any]) -> Any:
    """[L] list of identically-shaped layer trees -> one stacked tree.

    Leaves gain a leading layer axis; split it over ``pp`` to place L/S
    consecutive layers on each stage."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([layer[k] for layer in layers])
                for k in first}
    if isinstance(first, list):
        return [stack_layers([layer[i] for layer in layers])
                for i in range(len(first))]
    return torch.stack(list(layers))


def unstack_layers(stacked: Any) -> List[Any]:
    """Inverse of :func:`stack_layers`: each leaf unbound once, so that in
    the backward every layer's gradient returns to it in one stack (an
    index a layer would write a whole zeroed leaf for each use)."""
    cols = {path: t.unbind(0) for path, t in tree_paths(stacked)}
    n = len(next(iter(cols.values())))
    return [_map(lambda path, _, i=i: cols[path][i], stacked)
            for i in range(n)]


def to_pipeline_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """A Llama tree (a list of layers) in the pipelined layout that
    :func:`make_pipelined_loss` takes: ``{"embedding", "norm",
    ["lm_head"], "stacked"}``."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["stacked"] = stack_layers(params["layers"])
    return out


def pipeline_shardings(stacked_layers: Any, mesh: Mesh,
                       rules=None) -> Any:
    """Specs for a stacked layer tree: axis 0 over ``pp``, the other dims
    by ``spec_for`` and ``clean_spec`` (the tensor-parallel rules). Raises
    where the layer count does not divide ``pp``."""
    rules = rules or LLAMA_RULES
    pp = mesh.shape["pp"]

    def one(path, leaf):
        if leaf.shape[0] % pp:
            raise ValueError(f"{path}: {leaf.shape[0]} layers not divisible "
                             f"by pp={pp}")
        return ("pp",) + clean_spec(spec_for(path, rules),
                                    tuple(leaf.shape[1:]), mesh)

    return _map(one, stacked_layers)


def pipelined_specs(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """The specs of a pipelined tree: ``stacked`` by
    :func:`pipeline_shardings`, the rest by ``shardings_for_tree``
    (``LLAMA_RULES``: the embedding and head split over ``tp`` and
    ``fsdp``). Leaves need only a shape."""
    specs = shardings_for_tree(
        {k: v for k, v in params.items() if k != "stacked"}, mesh)
    specs["stacked"] = pipeline_shardings(params["stacked"], mesh)
    return specs


def make_stage_fn(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  remat: bool = True
                  ) -> Callable[[List[Any], torch.Tensor], torch.Tensor]:
    """Stage body: ``layer_fn(layer, x) -> x`` over the stage's layers in
    order, each recomputed in the backward (``torch.utils.checkpoint``)
    where ``remat`` is set. JAX's scans the stage's stacked tree; this
    one takes its layers as ``unstack_layers`` gives them, which
    ``spmd_pipeline`` does once a call."""
    def stage_fn(stage_layers, x):
        for layer in stage_layers:
            if remat and torch.is_grad_enabled():
                x = checkpoint(layer_fn, layer, x, use_reentrant=False)
            else:
                x = layer_fn(layer, x)
        return x

    return stage_fn


def spmd_pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                  stage_params: Any, microbatches: torch.Tensor, mesh: Mesh,
                  axis: str = "pp") -> torch.Tensor:
    """Run the GPipe schedule over ``axis``.

    ``stage_fn(stage_layers, x) -> y`` with ``y.shape == x.shape``
    (``make_stage_fn``); ``stage_params`` is this rank's stage (its shard
    of the stacked axis), or on a one-device mesh the whole stacked tree,
    cut here into the S stages; ``microbatches`` [M, mb, ...] is the local
    batch's queue, the same on every stage (only stage 0 takes it in).
    Returns the [M, mb, ...] outputs of the last stage, the same on every
    stage."""
    S, M = mesh.shape[axis], microbatches.shape[0]
    layers = unstack_layers(stage_params)
    if mesh.distributed:
        stages, local = [mesh.coords[axis]], [layers]
    else:
        n = len(layers) // S
        stages = list(range(S))
        local = [layers[s * n:(s + 1) * n] for s in stages]

    def flags(pred):
        return [torch.tensor(pred(s), device=microbatches.device)
                for s in stages]

    first, last = flags(lambda s: s == 0), flags(lambda s: s == S - 1)
    zeros = torch.zeros_like(microbatches[0])
    prev = [zeros] * len(stages)
    outputs = [zeros] * M
    for t in range(M + S - 1):
        # Stage 0 takes microbatch t from the queue; the later stages take
        # what the hop brought in at the end of the tick before.
        feed = microbatches[min(t, M - 1)]
        ys = [stage_fn(p, torch.where(f, feed, x))
              for p, f, x in zip(local, first, prev)]
        m = t - (S - 1)  # the last stage finishes microbatch m at tick t
        if m >= 0:
            for y, f in zip(ys, last):
                outputs[m] = torch.where(f, y, outputs[m])
        prev = rotate(ys, mesh, axis)
    out = torch.stack(outputs)
    # The outputs live on the last stage, zeros elsewhere: their sum over
    # the axis is theirs, exactly, and its gradient the identity.
    return allreduce_fwd(out, mesh, axis) if mesh.distributed else out


def _tp_layer_fn(layer, x, cos, sin, cfg, attn_impl, shard=None):
    """One transformer block on a stage's (gathered) layer: under
    ``shard`` its heads and ``d_ff`` are this rank's ``tp`` slice and the
    row-parallel products are summed over ``tp`` (Megatron's f and g)."""
    a, _ = llama._attention_block(layer, x, cos, sin, cfg,
                                  attn_impl=attn_impl, shard=shard)
    x = x + a
    return x + llama._mlp_block(layer, x, cfg, shard)


def _stage_leaves(params, cfg, mesh: Mesh, shard) -> Any:
    """This rank's stage of ``params["stacked"]``, each leaf gathered over
    its FSDP axes once (``Placement.param``: ``pp`` and ``tp`` stay
    split), as the in_specs of JAX's shard_map (``_stacked_in_specs``)
    gather them at the pipeline's boundary."""
    stacked = params["stacked"]
    if not mesh.distributed:
        return stacked
    want = cfg.n_layers // mesh.shape["pp"]
    for path, t in tree_paths(stacked, "stacked"):
        if t.shape[0] != want:
            raise ValueError(
                f"{path}: {t.shape[0]} layers on this rank, expected "
                f"{want}: pass this rank's shards (shard_params under "
                f"pipelined_specs)")
    return _map(shard.param, stacked, "stacked")


def pipelined_forward(params, tokens, cfg, *, mesh: Mesh,
                      n_microbatches: int, attn_impl=None, remat=True,
                      seq_offset: int = 0, shard=None):
    """The pipelined model's logits on this rank's rows, as
    ``training.loss_share``'s ``forward`` hook takes it: ``(logits,
    None)``. The embedding and the head run on every ``pp`` rank, the
    layers through ``spmd_pipeline``."""
    L = tokens.shape[1]
    cos, sin = rope_frequencies(cfg.head_dim, L, cfg.rope_theta,
                                device=tokens.device)
    stage = _stage_leaves(params, cfg, mesh, shard)
    x = llama._embed(params, tokens, cfg, shard)
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"local batch {b} not divisible into "
                         f"{n_microbatches} microbatches")
    if mesh.distributed:
        x = allreduce_bwd(x, mesh, "pp")

    def layer_fn(layer, h):
        return _tp_layer_fn(layer, h, cos, sin, cfg, attn_impl, shard)

    mb = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
    out = spmd_pipeline(make_stage_fn(layer_fn, remat=remat), stage, mb,
                        mesh)
    x = llama._final_norm(params, out.reshape(x.shape), cfg, shard)
    return llama._logits(params, x, cfg, shard), None


def make_pipelined_loss(mesh: Mesh, cfg, n_microbatches: int,
                        remat: bool = True, attn_impl=None):
    """Llama's loss with the layers pipelined over ``pp`` and tensor
    parallelism inside the stages: ``loss_fn(params, tokens, specs=None)``
    returns this rank's share of the global batch's mean next-token loss,
    as ``sharded_loss_fn`` does (the shares over the batch axes sum to the
    mean; ``pp`` and ``tp`` ranks hold the same share).

    ``params`` is the pipelined tree (``to_pipeline_params``): this rank's
    shards under ``specs`` (``pipelined_specs`` of the global tree), or on
    a one-device mesh the whole tree. ``attn_impl`` is the attention,
    ``flash_attention`` unless given. Raises where the layers do not
    divide ``pp``, the heads or ``d_ff`` do not divide ``tp``, and on
    ``sp`` or ``ep`` > 1, which JAX's pipelined loss does not run; the
    returned loss raises where the local batch does not split into
    ``n_microbatches``."""
    pp, tp = mesh.shape["pp"], mesh.shape["tp"]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"heads ({cfg.n_heads}/{cfg.n_kv_heads}) not "
                         f"divisible by tp={tp}")
    if cfg.d_ff % tp:
        raise ValueError(f"d_ff={cfg.d_ff} not divisible by tp={tp}")
    for axis in ("sp", "ep"):
        if mesh.shape[axis] > 1:
            raise ValueError(f"the pipelined loss runs no {axis} axis "
                             f"({axis}={mesh.shape[axis]})")
    forward = functools.partial(pipelined_forward, mesh=mesh,
                                n_microbatches=n_microbatches)

    def loss_fn(params, tokens, specs=None):
        return loss_share(params, tokens, cfg, mesh, attn_impl=attn_impl,
                          remat=remat, specs=specs, forward=forward)

    return loss_fn
