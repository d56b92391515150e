"""Ring attention: exact attention over sequences split on the ``sp`` axis.

Port of ``ray_tpu/parallel/ring_attention.py``. Each rank holds its query
shard while the K/V shards rotate around the ring; each step's block is
merged into the rank's running output by an online softmax (running max
and sum), so no rank holds more than its shards and their statistics.
The block step is one of:
  * ``"dense"``: einsum scores in fp32 over the whole block, differentiated
    by autograd (the oracle, fine at short shards);
  * ``"flash"``: ``ops.attention.flash_attention_stats``, which launches
    ``csrc/flash_stats.cu`` for a CUDA tensor, inside a
    ``torch.autograd.Function`` whose backward is the standard ring
    backward in plain fp32 PyTorch (probabilities rebuilt from the final
    merged statistics, the block gradients chunked over keys, and dK/dV
    rotating home with their blocks), as the JAX package's custom VJP is
    plain ``jnp``;
  * ``"auto"``: flash on CUDA when ``ops.attention.kernel_takes`` holds
    for the shards, dense elsewhere, as the JAX package's gate sends what
    its kernel does not tile to dense. The TPU's VMEM gate does not carry
    over: the kernel streams K/V tiles.

Where the ranks run (``parallel/mesh.py``): over a process group each rank
passes its own shards and a rotation is ``batch_isend_irecv`` to the next
rank; on a one-device mesh the ``sp`` ranks run in lockstep, their shards
a list and a rotation a turn of that list. Both share the block steps, the
merge and the backward, and launch the stats kernel once per (rank, ring
step), steps with nothing visible included, as JAX's scan does. K/V rotate
at their own kv-head count (GQA); they are never repeated to the query
heads first.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from ..ops.attention import NEG_INF, flash_attention_stats, kernel_takes
from . import collectives
from .mesh import Mesh, rank_shards

#: The backward's key chunk: its scratch is [B, H, L_local, 512] fp32.
_BWD_CHUNK = 512


def _ppermute(xs: List[torch.Tensor], mesh: Mesh,
              axis: str) -> List[torch.Tensor]:
    """Every ring rotation goes through this seam (the mirror of
    ``ulysses._all_to_all``), so tests can count the bytes that travel:
    K/V blocks and the backward's dK/dV shards move at their kv-head
    count. ``xs`` holds one shard per rank this process runs; rank j's
    shard moves to rank j + 1 (``collectives.rotate``)."""
    return collectives.rotate(xs, mesh, axis)


def _visible_rows(my_idx: int, src_idx: int, Lq: int, Lk: int, causal: bool,
                  device):
    """Per-query-row count of the ``src_idx`` block's visible key columns,
    in the block's local coordinates (global causal order), int32 [Lq],
    and the largest count."""
    if not causal:
        return torch.full((Lq,), Lk, dtype=torch.int32, device=device), Lk
    first = my_idx * Lq - src_idx * Lk + 1
    rows = (torch.arange(Lq, device=device) + first).clamp_(0, Lk)
    return rows.to(torch.int32), min(max(first + Lq - 1, 0), Lk)


def _block_attn(q, k, v, mask, scale):
    """One q-block x kv-block attention with running-softmax stats.
    q: [B, Lq, H, D], k/v: [B, Lk, H, D]; returns (unnormalised o
    [B, Lq, H, D], row max [B, H, Lq], row sum [B, H, Lq]). The max is kept
    out of autograd: the normalised output does not depend on it."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1).detach()
    p = torch.exp(s - m[..., None])
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return o, m, p.sum(dim=-1)


def _dense_step(q, k, v, vis, causal, scale):
    rep = q.shape[2] // k.shape[2]
    k, v = (t.float().repeat_interleave(rep, dim=2) for t in (k, v))
    mask = None
    if causal:
        cols = torch.arange(k.shape[1], device=q.device)
        mask = (cols[None, :] < vis[:, None])[None, None]
    return _block_attn(q.float(), k, v, mask, scale)


def _flash_step(q, k, v, vis, causal, scale):
    B, Lq, H, _ = q.shape
    return flash_attention_stats(q, k, v, vis[None, None].expand(B, H, Lq),
                                 scale=scale)


def _merge(acc, blk):
    """Online-softmax merge of the running (o, m, l) with a block's."""
    o_acc, m_acc, l_acc = acc
    o_blk, m_blk, l_blk = blk
    m_new = torch.maximum(m_acc, m_blk)
    alpha = torch.exp(m_acc - m_new)  # rescale the old accumulator
    beta = torch.exp(m_blk - m_new)
    o_new = (o_acc * alpha.transpose(1, 2)[..., None]
             + o_blk * beta.transpose(1, 2)[..., None])
    return o_new, m_new, l_acc * alpha + l_blk * beta


def _ring_forward(mesh, axis, q, k, v, causal, scale, step):
    """The forward schedule: per ring step, every rank's block step and
    merge, then K/V rotate. Returns (ranks' outputs normalised in q's dtype
    joined along dim 1, m and l joined along dim 2, l clamped to 1e-30)."""
    n = mesh.shape[axis]
    ranks, qs, ks, vs = rank_shards(mesh, axis, q, k, v)
    B, Lq, H, D = qs[0].shape
    Lk = ks[0].shape[1]
    state = [(torch.zeros(B, Lq, H, D, device=q.device),
              torch.full((B, H, Lq), NEG_INF, device=q.device),
              torch.zeros(B, H, Lq, device=q.device)) for _ in ranks]
    for i in range(n):
        for j, r in enumerate(ranks):
            vis, _ = _visible_rows(r, (r - i) % n, Lq, Lk, causal, q.device)
            state[j] = _merge(state[j], step(qs[j], ks[j], vs[j], vis,
                                             causal, scale))
        if i < n - 1:  # the last step's blocks have nowhere left to go
            ks, vs = _ppermute(ks, mesh, axis), _ppermute(vs, mesh, axis)
    l = torch.cat([s[2] for s in state], dim=2).clamp(min=1e-30)
    o = torch.cat([s[0] for s in state], dim=1)
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    return out, torch.cat([s[1] for s in state], dim=2), l


def _block_grads(qr, dor, mr, linv, di, k_blk, v_blk, vis_r, hi, scale):
    """(dq, dk, dv) of one ring block, fp32, with the query heads of each
    kv head as rows: qr, dor [B, Hkv, G·Lq, D]; mr, linv, di
    [B, Hkv, G·Lq]; vis_r [G·Lq, 1]. Keys are taken in chunks of
    ``_BWD_CHUNK`` up to ``hi``, the block's largest visible count (the
    chunks past it see nothing and add nothing)."""
    kb = k_blk.float().transpose(1, 2)  # [B, Hkv, Lk, D]
    vb = v_blk.float().transpose(1, 2)
    dq = torch.zeros_like(qr)
    dk = torch.zeros_like(kb)
    dv = torch.zeros_like(vb)
    for c0 in range(0, hi, _BWD_CHUNK):
        c1 = min(kb.shape[2], c0 + _BWD_CHUNK)
        kc, vc = kb[:, :, c0:c1], vb[:, :, c0:c1]
        seen = torch.arange(c0, c1, device=qr.device) < vis_r
        # Mask BEFORE exp: a row that sees nothing carries m = NEG_INF, and
        # exp(s - NEG_INF) would overflow; masked entries stay finite and
        # are zeroed.
        s = torch.where(seen, qr @ kc.transpose(-1, -2) * scale, NEG_INF)
        p = torch.where(seen, torch.exp(s - mr[..., None]) * linv[..., None],
                        0.0)
        dv[:, :, c0:c1] = p.transpose(-1, -2) @ dor
        ds = p * (dor @ vc.transpose(-1, -2) - di[..., None])
        dq += ds @ kc
        dk[:, :, c0:c1] = ds.transpose(-1, -2) @ qr
    return dq * scale, dk * scale, dv


def _ring_flash_bwd(mesh, axis, causal, scale, q, k, v, out, m, l, dout):
    """The ring backward from the final merged statistics: per ring step
    every rank's block gradients, then K/V and their dK/dV shards rotate
    together (dK/dV in fp32), so after the last rotation each shard's
    gradient is home."""
    n = mesh.shape[axis]
    ranks, qs, ks, vs, outs, dos = rank_shards(mesh, axis, q, k, v, out,
                                               dout)
    ms, ls = m.chunk(len(ranks), dim=2), l.chunk(len(ranks), dim=2)
    B, Lq, H, D = qs[0].shape
    Lk, Hkv = ks[0].shape[1], ks[0].shape[2]
    G = H // Hkv

    def rows(x):  # [B, L, H, D] -> [B, Hkv, G·L, D]; row g·L + i
        return x.float().reshape(B, Lq, Hkv, G, D).permute(0, 2, 3, 1, 4) \
            .reshape(B, Hkv, G * Lq, D)

    qr, dor = [rows(t) for t in qs], [rows(t) for t in dos]
    di = [(d * rows(o)).sum(-1) for d, o in zip(dor, outs)]
    mr = [t.reshape(B, Hkv, G * Lq) for t in ms]
    linv = [1.0 / t.reshape(B, Hkv, G * Lq) for t in ls]
    dq = [torch.zeros_like(t) for t in qr]
    dks = [torch.zeros(B, Lk, Hkv, D, device=q.device) for _ in ranks]
    dvs = [torch.zeros_like(t) for t in dks]
    for i in range(n):
        for j, r in enumerate(ranks):
            vis, hi = _visible_rows(r, (r - i) % n, Lq, Lk, causal, q.device)
            dq_p, dk_p, dv_p = _block_grads(
                qr[j], dor[j], mr[j], linv[j], di[j], ks[j], vs[j],
                vis.repeat(G)[:, None], hi, scale)
            dq[j] += dq_p
            dks[j] += dk_p.transpose(1, 2)
            dvs[j] += dv_p.transpose(1, 2)
        if i < n - 1:
            ks, vs = _ppermute(ks, mesh, axis), _ppermute(vs, mesh, axis)
        dks, dvs = _ppermute(dks, mesh, axis), _ppermute(dvs, mesh, axis)
    dq = torch.cat([t.reshape(B, Hkv, G, Lq, D).permute(0, 3, 1, 2, 4)
                    .reshape(B, Lq, H, D) for t in dq], dim=1)
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        out, m, l = _ring_forward(mesh, axis, q, k, v, causal, scale,
                                  _flash_step)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.args = (mesh, axis, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _ring_flash_bwd(*ctx.args, *ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis: str = "sp", causal: bool = False,
                   scale: Optional[float] = None,
                   block_impl: str = "auto",
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Exact attention with K/V rotating around the ``axis`` ring.

    On a process-group mesh q, k, v are this rank's shards
    [B, L / n, H, D], its contiguous block of positions (``shard_batch``);
    on a one-device mesh they are the global [B, L, H, D], cut into the n
    ranks' shards here. K/V may carry fewer heads (GQA). ``causal`` masks
    in global positions. ``block_impl`` picks the block step (module
    docstring). ``segment_ids`` are not applied and raise. Returns
    [B, L_q, H, D] in q's dtype, differentiable."""
    if segment_ids is not None:
        raise NotImplementedError(
            "ring_attention does not apply segment masking; use "
            "dense_attention(segment_ids=...) or pad documents apart "
            "(silently ignoring the mask would cross document "
            "boundaries)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if block_impl == "auto":
        block_impl = ("flash" if q.device.type == "cuda"
                      and kernel_takes(q, k, v) else "dense")
    if block_impl == "flash":
        return _RingFlash.apply(q, k, v, mesh, axis, causal, float(scale))
    if block_impl != "dense":
        raise ValueError(f"unknown block_impl {block_impl!r}")
    out, _, _ = _ring_forward(mesh, axis, q, k, v, causal, scale,
                              _dense_step)
    return out


def check_axes(mesh: Mesh, q: torch.Tensor, k: torch.Tensor,
               batch_axes, head_axis: Optional[str]) -> None:
    """What JAX's ``shard_map`` spec ``P(batch_axes, axis, head_axis)``
    asks of the inputs. The axes must be the mesh's. On a one-device mesh,
    which takes global tensors, the batch must split over ``batch_axes``
    and the query and kv heads over ``head_axis``; on a process-group mesh
    the tensors are this rank's already (its rows, positions and heads),
    and its heads must group (GQA)."""
    axes = tuple(batch_axes) + ((head_axis,) if head_axis else ())
    unknown = [a for a in axes if a not in mesh.shape]
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}")
    B, H, Hkv = q.shape[0], q.shape[2], k.shape[2]
    if mesh.distributed:
        if Hkv < 1 or H % Hkv:
            raise ValueError(f"{H} local query heads do not group over "
                             f"{Hkv} kv heads")
        return
    rows = math.prod(mesh.shape[a] for a in batch_axes)
    heads = mesh.shape[head_axis] if head_axis else 1
    if B % rows or H % heads or Hkv % heads:
        raise ValueError(f"batch {B} over {batch_axes} ({rows}) or heads "
                         f"{H}/{Hkv} over {head_axis} ({heads}) do not split")


def make_ring_attention(mesh: Mesh, *, causal: bool = True,
                        axis: str = "sp", batch_axes=("dp", "fsdp"),
                        head_axis: str = "tp", block_impl: str = "auto"):
    """Ring attention over ``mesh``'s ``axis`` as an ``attn_impl`` for
    ``models.llama``: ``attend(q, k, v, causal=causal, scale=None)``.

    On a one-device mesh ``attend`` takes the global [B, L, H, D] tensors,
    as JAX's ``shard_map`` wrapper does, and runs the ranks in lockstep; on
    a process-group mesh it takes this rank's shards (its rows of the
    batch over ``batch_axes``, its heads over ``head_axis``) and rotates
    over the axis's group. ``check_axes`` holds the inputs to the axes."""

    def attend(q, k, v, causal: bool = causal,
               scale: Optional[float] = None):
        check_axes(mesh, q, k, batch_axes, head_axis)
        return ring_attention(q, k, v, mesh, axis=axis, causal=causal,
                              scale=scale, block_impl=block_impl)

    return attend
