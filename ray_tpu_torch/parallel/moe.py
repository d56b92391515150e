"""Mixture of experts: the router, the dense all-experts FFN, and expert
parallelism over the ``ep`` axis.

Port of ``ray_tpu/parallel/moe.py``. Experts are stacked on a leading E
dim (``[E, D, F]`` and ``[E, F, D]``), so ``ep`` splits them into blocks
of E/ep. Two implementations with JAX's semantics:
  * ``moe_ffn_dense`` runs every expert on every token and weights their
    outputs by the top-k gates: O(E) products, the single-device path and
    the oracle. The expert products are plain ``torch`` batched matmuls,
    as JAX's are plain ``einsum``s outside any Pallas kernel.
  * ``ep_moe_ffn`` sends each token to its experts' ranks with one
    ``alltoall`` each way, in GShard's capacity buffers: a rank sends at
    most ``capacity`` of its tokens to any one expert, earlier gate slots
    first, then token order, and drops the rest, exactly where JAX drops
    them. JAX writes the dispatch and combine as one-hot ``[T, E, C]``
    einsums; here each buffer row is gathered from its one token and each
    token sums its k rows, the same fp32 values without the one-hot
    tensors (a row holds at most one token, a token at most k products).
    Both exchanges carry fp32 buffers and the combine is fp32, as JAX's.

JAX runs ``ep_moe_ffn`` inside ``shard_map`` and its ``lax.all_to_all``
is differentiable. Here each rank calls it eagerly on its own rows over a
process-group mesh; ``collectives.alltoall`` carries the exchange back as
its gradient. Over ``tp`` the expert FFN is Megatron's, as in JAX: each
rank holds F/tp hidden units of every local expert, Megatron's f
(``collectives.allreduce_bwd``) before ``w_gate``/``w_up`` and g
(``allreduce_fwd``, JAX's ``psum`` over tp) after ``w_down``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import collectives
from .mesh import BATCH_AXES, Mesh
from .sharding import clean_spec

#: Each expert leaf's spec: its experts over ep, its d_ff over tp and its
#: d_model over fsdp (JAX's ``expert_shardings``).
EXPERT_SPECS = {
    "w_gate": ("ep", "fsdp", "tp"),
    "w_up": ("ep", "fsdp", "tp"),
    "w_down": ("ep", "tp", "fsdp"),
}


def router_probs(x: torch.Tensor, w_router: torch.Tensor) -> torch.Tensor:
    """Softmax router in fp32. x: [..., D], w_router: [D, E] -> [..., E]."""
    return torch.softmax(x.float() @ w_router.float(), dim=-1)


def top_k_gates(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gate values, renormalised (Mixtral's), and expert indices.
    Equal probabilities order the lower index first, as ``lax.top_k``
    does (``torch.topk`` promises no order for ties, a stable sort does)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    return vals / vals.sum(-1, keepdim=True).clamp(min=1e-9), idx


def load_balance_loss(probs: torch.Tensor, gate_idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch's aux loss, E * sum_e(frac_tokens_e * mean_prob_e), over the
    top-1 assignments."""
    assign = F.one_hot(gate_idx[..., 0], n_experts).float()
    frac_tokens = assign.reshape(-1, n_experts).mean(0)
    mean_probs = probs.reshape(-1, n_experts).mean(0)
    return n_experts * (frac_tokens * mean_probs).sum()


def _expert_ffn(h: torch.Tensor, experts: Dict[str, torch.Tensor],
                tp_mesh: Optional[Mesh] = None) -> torch.Tensor:
    """SwiGLU over stacked experts. h: [E, S, D], weights [E, D, F] and
    [E, F, D]. With ``tp_mesh`` each rank holds F/tp hidden units: f before
    the products, g after them."""
    if tp_mesh is not None:
        h = collectives.allreduce_bwd(h, tp_mesh, "tp")
    g = torch.bmm(h, experts["w_gate"])
    u = torch.bmm(h, experts["w_up"])
    y = torch.bmm(F.silu(g) * u, experts["w_down"])
    if tp_mesh is not None:
        y = collectives.allreduce_fwd(y, tp_mesh, "tp")
    return y


def moe_ffn_dense(x: torch.Tensor, w_router: torch.Tensor,
                  experts: Dict[str, torch.Tensor], k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference MoE: every expert on every token, gated by the top-k
    weights. x: [B, L, D]; expert leaves lead with E. Returns (out
    [B, L, D], aux scalar). The gates are cast to the experts' dtype before
    the combining product, as JAX casts them."""
    E = w_router.shape[1]
    probs = router_probs(x, w_router)
    gate_vals, gate_idx = top_k_gates(probs, k)
    gates = (F.one_hot(gate_idx, E) * gate_vals[..., None]).sum(-2)
    B, L, D = x.shape
    y = _expert_ffn(x.reshape(1, B * L, D).expand(E, B * L, D), experts)
    out = torch.einsum("te,etd->td", gates.reshape(B * L, E).to(y.dtype),
                       y).reshape(B, L, D)
    return out.to(x.dtype), load_balance_loss(probs, gate_idx, E)


def default_capacity(tokens_per_device: int, n_experts: int, k: int,
                     capacity_factor: float) -> int:
    """Static per-expert capacity per device (GShard): each device may send
    at most C of its tokens to any one expert, so an expert's buffer over
    the group is ep * C = cf * total * k / E."""
    return max(k, int(math.ceil(
        capacity_factor * tokens_per_device * k / n_experts)))


def capacity_slots(gate_idx: torch.Tensor, n_experts: int,
                   capacity: int) -> torch.Tensor:
    """Each (token, gate slot)'s row ``e * capacity + position`` in the
    flat ``[E * capacity]`` dispatch buffer, or ``E * capacity`` where the
    assignment is dropped. Earlier gate slots take places first, then
    token order (JAX's loop). gate_idx: [T, k] -> [T, k] int64."""
    counts = torch.zeros(n_experts, dtype=torch.long, device=gate_idx.device)
    slots = []
    for j in range(gate_idx.shape[1]):
        m = F.one_hot(gate_idx[:, j], n_experts)           # [T, E]
        pos = ((m.cumsum(0) - 1 + counts) * m).sum(-1)      # queue position
        counts = counts + m.sum(0)
        slots.append(torch.where(pos < capacity,
                                 gate_idx[:, j] * capacity + pos,
                                 n_experts * capacity))
    return torch.stack(slots, dim=1)


def ep_moe_ffn(x: torch.Tensor, w_router: torch.Tensor,
               experts_local: Dict[str, torch.Tensor], k: int,
               capacity: int, mesh: Mesh, axis: str = "ep",
               tp: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE in one rank of a process-group mesh.

    x: [B_local, L, D], this rank's tokens (``ep`` doubles as a data axis
    for the rest of the model). ``experts_local``: this rank's E/ep
    experts (their d_ff split over ``tp`` when ``tp``). Returns (out
    [B_local, L, D], aux): aux is this rank's token shard's load-balance
    statistic; JAX's ``pmean``s it over ``axis``."""
    n = mesh.shape[axis]
    E = w_router.shape[1]
    B, L, D = x.shape
    T = B * L
    xt = x.reshape(T, D)
    probs = router_probs(xt, w_router)                   # [T, E]
    gate_vals, gate_idx = top_k_gates(probs, k)          # [T, k]
    slots = capacity_slots(gate_idx, E, capacity)        # [T, k]

    # Each buffer row's token (T, a zero row, where none), then the
    # exchange: every rank gets its experts' rows from every rank.
    rows = E * capacity
    tokens = torch.arange(T, device=x.device).repeat_interleave(k)
    src = torch.full((rows + 1,), T, dtype=torch.long, device=x.device) \
        .scatter_(0, slots.reshape(-1), tokens)[:rows]
    xt32 = torch.cat([xt.float(), xt.new_zeros(1, D, dtype=torch.float32)])
    buf = xt32.index_select(0, src).reshape(n, E // n, capacity, D)
    buf = collectives.alltoall(buf, mesh, axis, split_axis=0, concat_axis=0)
    buf = buf.transpose(0, 1).reshape(E // n, n * capacity, D)

    y = _expert_ffn(buf.to(x.dtype), experts_local, mesh if tp else None)

    # Route the results back; each token sums its kept rows by its gates.
    y = y.float().reshape(E // n, n, capacity, D).transpose(0, 1)
    y = collectives.alltoall(y, mesh, axis, split_axis=0, concat_axis=0)
    y = torch.cat([y.reshape(rows, D), y.new_zeros(1, D)])
    out = (y.index_select(0, slots.reshape(-1)).reshape(T, k, D)
           * gate_vals[..., None]).sum(1)
    aux = load_balance_loss(probs, gate_idx, E)
    return out.reshape(B, L, D).to(x.dtype), aux


def make_ep_moe_ffn(mesh: Mesh, k: int, capacity_factor: float = 2.0,
                    batch_axes=BATCH_AXES):
    """The expert-parallel MoE over a process-group mesh, as the
    ``moe_ffn(x, router, experts) -> (out, aux)`` of ``models.mixtral``.

    Each rank passes its rows x [B_local, L, D] (the batch split over
    ``batch_axes``), the router whole, and its experts as
    ``mixtral_shardings`` leaves them after the FSDP gathers: E/ep experts,
    d_ff split over ``tp`` where the mesh has it. The capacity is
    ``default_capacity`` of the rank's tokens. ``aux`` is this rank's share
    of JAX's: its token shard's statistic over the number of token shards
    (the product of ``batch_axes``' sizes), so the shares of the ranks
    that split the batch sum to JAX's mean over them, and no collective
    runs for it in the forward."""
    if not mesh.distributed:
        raise ValueError("make_ep_moe_ffn needs a process-group mesh")
    tp = mesh.shape["tp"] > 1
    n_data = math.prod(mesh.shape[a] for a in batch_axes)

    def fn(x, w_router, experts):
        capacity = default_capacity(x.shape[0] * x.shape[1],
                                    w_router.shape[1], k, capacity_factor)
        out, aux = ep_moe_ffn(x, w_router, experts, k, capacity, mesh, tp=tp)
        return out, aux / n_data

    return fn


def expert_shardings(experts: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Specs for a stacked expert tree (``EXPERT_SPECS``; any other leaf
    over ep on its first dim), each cleaned against its leaf's shape."""
    return {name: clean_spec(EXPERT_SPECS.get(name, ("ep",)),
                             tuple(leaf.shape), mesh)
            for name, leaf in experts.items()}
