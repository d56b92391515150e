"""Parameter sharding: DP / FSDP / TP as explicit shards on a process-group
mesh.

Port of ``ray_tpu/parallel/sharding.py``. ``LLAMA_RULES``, ``spec_for``,
``_tree_paths`` and ``clean_spec`` are copies of that module's logic over
strings and shapes (the module imports JAX at its top, so the port keeps
its own). A spec is a tuple with one entry per leading dim, each ``None``,
an axis name or a tuple of axis names, major first: the counterpart of
``PartitionSpec``.

In JAX, XLA places each leaf's shards and inserts the collectives. Here
each rank holds its shards as plain tensors (``shard_params``), and
``models.llama`` takes a ``Placement`` that says what to do with them:
every weight split over ``fsdp`` is gathered over that axis just before
its layer uses it, and its gradient comes back reduce-scattered
(``collectives.gather_param``); weights split over ``tp`` stay split, in
Megatron's convention (``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` and
the vocab of ``lm_head`` column-parallel, ``wo`` and ``w_down``
row-parallel and summed over ``tp``, the embedding's vocab split and its
lookup summed over ``tp``). ``parallel.training.sharded_loss_fn`` runs a
step on such shards.

An expert leaf of an MoE tree (``parallel/moe.py``'s ``expert_shardings``)
also stays split over ``ep``: a rank holds its own experts and the tokens
come to them.

A stacked layer leaf of the pipelined tree (``parallel/pipeline.py``'s
``pipeline_shardings``) stays split over ``pp``: a rank holds its stage's
layers.

``stage_submesh`` is one MPMD pipeline stage's mesh: ``fsdp`` only, over
the ranks of the stage's own process group (the ``pp`` axis lies between
the stages' programs). ``constrain`` (a sharding hint inside ``jit``) has no eager counterpart:
each rank's tensors already are its shards. ``apply_shardings`` is
``shard_params``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Set, Tuple

import torch

from . import collectives
from .mesh import BATCH_AXES, Mesh

Spec = Tuple[Any, ...]

# Transformer sharding rules, Megatron convention:
#   attn qkv:    (d_model, heads*head_dim) -> column-parallel: dim 1 on tp
#   attn out:    (heads*head_dim, d_model) -> row-parallel: dim 0 on tp
#   mlp up/gate: (d_model, d_ff)           -> column-parallel
#   mlp down:    (d_ff, d_model)           -> row-parallel
# fsdp shards the other big dim (ZeRO-3).
LLAMA_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*embedding$", ("tp", "fsdp")),
    (r".*(wq|wk|wv|w_qkv)$", ("fsdp", "tp")),
    (r".*wo$", ("tp", "fsdp")),
    (r".*(w_gate|w_up)$", ("fsdp", "tp")),
    (r".*w_down$", ("tp", "fsdp")),
    (r".*lm_head$", ("fsdp", "tp")),
    (r".*(norm|scale|bias)$", ()),
    (r".*", ()),
)


# ViT family (models/vit.py): the same Megatron convention, qkv and up
# column-parallel on tp, out and down row-parallel; patch embed
# column-parallel; pos, cls and norms replicated; classifier head
# column-parallel. Paths are '/'-joined.
VIT_RULES: Tuple[Tuple[str, Spec], ...] = (
    (r".*patch_embed/w$", ("fsdp", "tp")),
    (r".*(wq|wk|wv)$", ("fsdp", "tp")),
    (r".*wo$", ("tp", "fsdp")),
    (r".*w_up$", ("fsdp", "tp")),
    (r".*w_down$", ("tp", "fsdp")),
    (r".*head/w$", ("fsdp", "tp")),
    (r".*(pos_embed|cls_token|norm|scale|bias|/b)$", ()),
    (r".*", ()),
)

#: The axis whose shards stay split in the model's products.
TP = "tp"
#: The axes ``Placement.param`` leaves split: tp (Megatron's products), ep
#: (each rank's own experts) and pp (each stage's own layers).
KEPT_AXES = (TP, "ep", "pp")


def spec_for(path: str, rules: Sequence[Tuple[str, Spec]] = LLAMA_RULES
             ) -> Spec:
    for pattern, spec in rules:
        if re.fullmatch(pattern, path):
            return spec
    return ()


def _items(node) -> Optional[Iterator]:
    if isinstance(node, dict):
        return iter(node.items())
    if isinstance(node, list):
        return iter(enumerate(node))
    return None


def tree_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for each leaf of a tree of dicts and lists, in
    order (dicts in insertion order), paths ``/``-joined as JAX's
    ``_tree_paths`` joins key paths. Anything else is a leaf: a tensor,
    a spec tuple."""
    items = _items(tree)
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from tree_paths(v, f"{prefix}/{k}" if prefix else str(k))


def _map(fn, tree: Any, prefix: str = "") -> Any:
    """The tree's mirror with ``fn(path, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def _tree_paths(tree: Any) -> Any:
    """Mirror tree with ``/``-joined string paths at the leaves."""
    return _map(lambda path, _: path, tree)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Set[str]:
    """Every axis a spec splits some dim over."""
    return {a for entry in spec for a in _axes(entry)}


def clean_spec(spec: Spec, dims: Sequence[int], mesh: Mesh) -> Spec:
    """Drop spec axes that don't divide the corresponding dimension."""
    cleaned = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(dims):
            cleaned.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in _axes(axis))
        cleaned.append(axis if dims[i] % size == 0 else None)
    while cleaned and cleaned[-1] is None:
        cleaned.pop()
    return tuple(cleaned)


def shardings_for_tree(tree: Any, mesh: Mesh,
                       rules: Sequence[Tuple[str, Spec]] = LLAMA_RULES
                       ) -> Any:
    """Spec tree for a parameter tree by name patterns, each cleaned
    against its leaf's global shape. Leaves need only a ``shape`` (a
    ``meta`` tensor will do). Axes of size 1 stay in a spec: they split
    nothing, so one rule set serves every ``MeshSpec``."""
    return _map(lambda path, leaf: clean_spec(
        spec_for(path, rules), tuple(getattr(leaf, "shape", ())), mesh),
        tree)


def _block(mesh: Mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """This rank's block index along a dim split over ``axes`` (major
    first, JAX's device order) and the number of blocks."""
    index, n = 0, 1
    for a in axes:
        index = index * mesh.shape[a] + mesh.coords[a]
        n *= mesh.shape[a]
    return index, n


def _shard(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    for dim, entry in enumerate(spec):
        index, n = _block(mesh, _axes(entry))
        if n > 1:
            t = t.chunk(n, dim=dim)[index]
    return t.detach().clone()


def shard_params(tree: Any, mesh: Mesh, specs: Any = None) -> Any:
    """This rank's shards of a global tree, each leaf cut to its contiguous
    block of each dim its spec splits (the counterpart of
    ``apply_shardings``); fresh tensors, so the global tree can be freed.
    ``specs`` defaults to ``shardings_for_tree(tree, mesh)``. A one-device
    mesh takes global tensors, so it returns ``tree`` as it is."""
    if not mesh.distributed:
        return tree
    if specs is None:
        specs = shardings_for_tree(tree, mesh)
    flat = dict(tree_paths(specs))
    return _map(lambda path, t: _shard(t, flat[path], mesh), tree)


@torch.no_grad()
def _gather(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """``t``'s blocks gathered over every axis of its spec, minor axes
    first."""
    for dim, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            t = collectives.allgather(t, mesh, a, gather_axis=dim)
    return t


def gather_params(shards: Any, mesh: Mesh, specs: Any) -> Any:
    """The global tree from every rank's shards, exactly: the inverse of
    ``shard_params``. Every rank must call it."""
    if not mesh.distributed:
        return shards
    flat = dict(tree_paths(specs))
    return _map(lambda path, t: _gather(t, flat[path], mesh), shards)


def optimizer_shardings(optimizer: torch.optim.Optimizer,
                        specs: Any) -> Dict[int, Dict[str, Spec]]:
    """Each optimizer state entry's spec, keyed as
    ``optimizer.state_dict()["state"]``: a state tensor of its parameter's
    shape (AdamW's ``exp_avg`` and ``exp_avg_sq``) carries the parameter's
    spec, anything else (``step``) is replicated. ``specs`` mirrors the
    tree whose leaves the optimizer was given, in tree order
    (``models.trainable``). AdamW is elementwise, so a step on shards is
    the step on the global tree, cut the same way."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    leaf_specs = [s for _, s in tree_paths(specs)]
    if len(leaf_specs) != len(params):
        raise ValueError(f"{len(leaf_specs)} specs for {len(params)} "
                         f"optimizer parameters")
    return {i: {k: spec if isinstance(v, torch.Tensor) and
                v.shape == p.shape else ()
                for k, v in optimizer.state[p].items()}
            for i, (p, spec) in enumerate(zip(params, leaf_specs))}


def stage_submesh(n_devices: int, device=None,
                  backend: Optional[str] = None) -> Mesh:
    """An fsdp-only mesh for ONE pipeline stage of the MPMD pipeline (the
    ``pp`` axis lives BETWEEN programs — each stage is its own program
    over its own ranks — so the stage's mesh carries only the
    intra-stage axis). Inside a process group of ``n_devices`` ranks it
    spans them all; without one it is a one-device mesh of that shape.
    The same ``LLAMA_RULES`` serve a stage's subtree unchanged: stage
    trees keep the ``layers/<i>/wq`` paths the rules match on."""
    from .mesh import MeshSpec, make_mesh

    return make_mesh(MeshSpec(fsdp=n_devices), device=device,
                     backend=backend)


def activation_sharding(mesh: Mesh) -> Spec:
    """The spec of an activation ``[B, L, D]`` between stages: the batch
    over the data-like axes, the rest whole. ``mesh.shard_batch`` cuts a
    batch this way (and its positions over ``sp``)."""
    return (BATCH_AXES, None, None)


@dataclasses.dataclass(frozen=True)
class VocabShard:
    """This rank's slice ``[start, start + size)`` of a vocab of ``total``
    split over ``axis``, as the losses take it (``ops.layers``,
    ``ops.chunked_xent``)."""

    mesh: Mesh
    axis: str
    start: int
    total: int

    def reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the vocab's shards, outside autograd."""
        return collectives.allreduce(x, self.mesh, self.axis, op)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the shards; its gradient is the identity, since
        every shard then computes the same loss from it."""
        return collectives.allreduce_fwd(x, self.mesh, self.axis)


class Placement:
    """A Llama or Mixtral parameter tree's shards on a process-group mesh,
    as ``models.llama``, ``models.mixtral`` and ``parallel.pipeline`` use
    them: ``specs`` is ``shardings_for_tree`` (``LLAMA_RULES``),
    ``mixtral_shardings`` or ``pipelined_specs`` of the global tree, or
    None for a tree replicated on every rank.

    ``param`` gathers a leaf over every axis of its spec but ``tp``,
    ``ep`` and ``pp``, with a reduce-scatter as its gradient. Where the
    specs split the model's products over ``tp`` (``tp`` > 1), each rank
    holds ``n_heads / tp`` query heads, ``n_kv_heads / tp`` kv heads,
    ``d_ff / tp`` hidden units and ``vocab_size / tp`` rows of the vocab
    (a Mixtral's experts too); ``enter`` and ``leave``
    are Megatron's f and g around each split block, ``embed`` the
    vocab-split lookup, and ``vocab`` the loss's slice. Otherwise ``tp``
    ranks run the whole model each, on the same rows."""

    def __init__(self, mesh: Mesh, cfg, specs: Any = None):
        if not mesh.distributed:
            raise ValueError("a Placement needs a process-group mesh")
        self.mesh = mesh
        self.specs = dict(tree_paths(specs)) if specs is not None else {}
        for path, spec in self.specs.items():
            if any(TP in _axes(e) and len(_axes(e)) > 1 for e in spec):
                raise ValueError(f"{path}: spec {spec} splits one dim over "
                                 f"tp and another axis")
        split = any(TP in spec_axes(s) for s in self.specs.values())
        self.tp = mesh.shape[TP] if split else 1
        self.vocab = None
        if self.tp > 1:
            for name in ("n_heads", "n_kv_heads", "d_ff", "vocab_size"):
                if getattr(cfg, name) % self.tp:
                    raise ValueError(
                        f"{name}={getattr(cfg, name)} does not split over "
                        f"tp={self.tp}: the port splits heads, d_ff and the "
                        f"vocab over tp")
            size = cfg.vocab_size // self.tp
            self.vocab = VocabShard(mesh, TP, mesh.coords[TP] * size,
                                    cfg.vocab_size)

    def param(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``path`` as the model uses it: gathered over its axes but
        ``KEPT_AXES``, minor axes first."""
        for dim, entry in enumerate(self.specs.get(path, ())):
            for a in reversed(_axes(entry)):
                if a not in KEPT_AXES:
                    t = collectives.gather_param(t, self.mesh, a, dim)
        return t

    def layer(self, i: int, layer: Dict[str, Any]) -> Dict[str, Any]:
        """Layer ``i``'s leaves as ``param`` gives them, nested dicts (an
        MoE layer's ``experts``) included."""
        return _map(self.param, layer, f"layers/{i}")

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a tp-split block: f, whose gradient sums the ranks'
        parts."""
        if self.tp == 1:
            return x
        return collectives.allreduce_bwd(x, self.mesh, TP)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        """The output of a tp-split block: g, the sum of the ranks' parts."""
        if self.tp == 1:
            return x
        return collectives.allreduce_fwd(x, self.mesh, TP)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """The rows of ``tokens`` in the embedding ``table`` (this rank's
        vocab slice when it is split: its own tokens' rows, zeros for the
        others, summed over ``tp``)."""
        if self.vocab is None:
            return table[tokens.long()]
        local = tokens.long() - self.vocab.start
        here = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)]
        return self.leave(torch.where(here[..., None], rows, 0))
