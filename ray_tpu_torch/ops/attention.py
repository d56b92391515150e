"""Attention: the Hopper flash-attention kernels and their plain versions.
Layout throughout: [B, L, H, D]; K/V may carry fewer heads (GQA).

Port of ``ray_tpu/ops/attention.py``:
  * ``flash_attention`` is differentiable. For a CUDA tensor its forward
    launches ``csrc/flash_fwd.cu`` and, when a gradient is wanted, its
    backward launches the dK/dV and dQ kernels of ``csrc/flash_bwd.cu``
    (or raises); for a CPU tensor both run the plain versions. The kernels
    replace ``_flash_attention_bhld`` (``_flash_kernel``) and both halves
    of ``_tpu_flash`` (the Mosaic flash kernels); the source notes in the
    ``.cu`` files say what bounds them.
  * ``flash_attention_stats`` is ring attention's block step: the
    unnormalised fp32 output and the rows' max and sum, with a per-row
    count of visible keys. For a CUDA tensor it launches
    ``csrc/flash_stats.cu``, which replaces ``_flash_stats_bhld``
    (``_flash_stats_kernel``); it defines no gradient (the ring's own
    backward is in ``parallel/ring_attention.py``).
  * ``flash_attention_plain``, ``flash_attention_bwd_plain`` and
    ``flash_attention_stats_plain`` are the same blockwise fp32 math in
    PyTorch. The CPU tests run them, and the chip check holds the kernels
    against them; nothing on the CUDA path calls them.
  * ``dense_attention`` is the JAX package's oracle. ``flash_attention``
    sends a CUDA tensor there when ``kernel_takes`` says the kernels do not
    take its shape, dtype or options (a head dim outside {64, 128}, a dtype
    other than fp32 and bf16, segment ids), as the JAX package sends what
    its TPU kernel does not tile, and counts it in ``dense_routes``.

For bf16 inputs every kernel runs on the tensor cores (``csrc/flash_tc.cuh``
and, for the backward, ``csrc/flash_tc_bwd.cuh``: wgmma products fed by
``cp.async``), which need each row of q, k and v on a 16-byte boundary;
for fp32 inputs the products run on the CUDA cores. Each kernel is built
at its first CUDA use with ``nvcc`` into ``ray_tpu_torch/_build/``, keyed
by a hash of its ``.cu`` and every header (``source_digest``), and loaded
with ``ctypes``. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

NEG_INF = -1e30

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
#: The kernel libraries, each built from ``csrc/<name>.cu``.
KERNELS = ("flash_fwd", "flash_bwd", "flash_stats")
_HEAD_DIMS = (64, 128)
#: The query tile of the bf16 forward and stats kernels (the tensor-core
#: core, ``csrc/flash_tc.cuh``); their plain versions follow its tiles.
_TC_BLOCK_Q = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Forward kernel launches made by ``flash_attention``; a run that resets
#: it and reads it after shows that its path went through the kernel.
launches = 0
#: Backward calls that launched the kernels: each launches the dK/dV
#: kernel and the dQ kernel once.
bwd_launches = 0
#: Launches of the stats kernel made by ``flash_attention_stats``.
stats_launches = 0
#: Calls of ``flash_attention`` on CUDA tensors that ``kernel_takes``
#: declined and ``dense_attention`` ran instead.
dense_routes = 0

_libs: dict = {}
_lib_lock = threading.Lock()


def _tc_block_k(head_dim: int) -> int:
    """The tensor-core core's key tile: 128 keys at D = 64, 64 at D = 128."""
    return 128 if head_dim <= 64 else 64


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Reference attention: fp32 scores, finite ``NEG_INF`` mask, the causal
    mask offset by ``Lk - Lq``, K/V repeated for GQA."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    Hq, Hk = q.shape[2], k.shape[2]
    if Hk != Hq:
        k = k.repeat_interleave(Hq // Hk, dim=2)
        v = v.repeat_interleave(Hq // Hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Lq, Lk = q.shape[1], k.shape[1]
        rows = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        mask = rows >= torch.arange(Lk, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        s = torch.where(seg[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = False,
                          scale: Optional[float] = None,
                          block_q: Optional[int] = None,
                          block_k: Optional[int] = None,
                          return_lse: bool = False):
    """The forward kernel's math in PyTorch: per (query block, key block)
    an fp32 online softmax, masked probabilities set to 0, causal block
    skipping, any L (the last blocks are short), output divided by
    max(l, 1e-30) and cast to q's dtype. The blocks default to the bf16
    kernel's tiles. With ``return_lse`` it also returns each row's
    log-sum-exp of the scaled scores, fp32 [B, H, Lq], as ``(o, lse)``."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    block_q = block_q or _TC_BLOCK_Q
    block_k = block_k or _tc_block_k(D)
    if causal and Lq != Lk:
        raise ValueError(f"causal flash attention needs Lq == Lk, got "
                         f"{Lq} and {Lk}")
    if scale is None:
        scale = D ** -0.5
    group = H // k.shape[2]
    qf = q.float().transpose(1, 2) * scale                    # [B,H,Lq,D]
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    out = torch.empty(B, H, Lq, D, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=q.device)
    for q0 in range(0, Lq, block_q):
        qb = qf[:, :, q0:q0 + block_q]
        nq = qb.shape[2]
        rows = torch.arange(q0, q0 + nq, device=q.device)[:, None]
        m = torch.full((B, H, nq), NEG_INF, device=q.device)
        l = torch.zeros(B, H, nq, device=q.device)
        acc = torch.zeros(B, H, nq, D, device=q.device)
        hi = min(Lk, q0 + nq) if causal else Lk
        for k0 in range(0, hi, block_k):
            kb = kf[:, :, k0:k0 + block_k]
            s = qb @ kb.transpose(-1, -2)
            if causal:
                cols = torch.arange(k0, k0 + kb.shape[2],
                                    device=q.device)[None, :]
                visible = rows >= cols
                s = torch.where(visible, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            if causal:
                p = torch.where(visible, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p @ vf[:, :, k0:k0 + block_k]
            m = m_new
        denom = l.clamp(min=1e-30)
        out[:, :, q0:q0 + nq] = acc / denom[..., None]
        lse[:, :, q0:q0 + nq] = m + torch.log(denom)
    o = out.transpose(1, 2).to(q.dtype)
    return (o, lse) if return_lse else o


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              causal: bool = False,
                              scale: Optional[float] = None,
                              block_q: int = 64, block_k: int = 32):
    """The backward kernels' math in PyTorch: per (query block, key block)
    recompute p = exp(scale q.k - lse) in fp32 (masked ones 0, causal block
    skipping, any L), then dV += P^T dO, dS = P (dO V^T - di) with
    di = rowsum(o * dO), dK += scale dS^T Q and dQ += scale dS K. dK and dV
    of a kv head sum over its group of query heads. Returns
    ``(dq, dk, dv)`` in the dtypes of q, k and v."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if causal and Lq != Lk:
        raise ValueError(f"causal flash attention needs Lq == Lk, got "
                         f"{Lq} and {Lk}")
    if scale is None:
        scale = D ** -0.5
    group = H // Hkv
    qf = q.float().transpose(1, 2) * scale                    # [B,H,Lq,D]
    kf = k.float().transpose(1, 2).repeat_interleave(group, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, dim=1)
    dof = do.float().transpose(1, 2)
    di = bwd_di(o, do)                                        # [B,H,Lq]
    dq = torch.zeros(B, H, Lq, D, device=q.device)
    dk = torch.zeros(B, H, Lk, D, device=q.device)
    dv = torch.zeros(B, H, Lk, D, device=q.device)
    for q0 in range(0, Lq, block_q):
        q1 = min(Lq, q0 + block_q)
        rows = torch.arange(q0, q1, device=q.device)[:, None]
        hi = min(Lk, q1) if causal else Lk
        for k0 in range(0, hi, block_k):
            k1 = min(Lk, k0 + block_k)
            s = qf[:, :, q0:q1] @ kf[:, :, k0:k1].transpose(-1, -2)
            p = torch.exp(s - lse[:, :, q0:q1, None])
            if causal:
                cols = torch.arange(k0, k1, device=q.device)[None, :]
                p = torch.where(rows >= cols, p, 0.0)
            dob = dof[:, :, q0:q1]
            dv[:, :, k0:k1] += p.transpose(-1, -2) @ dob
            ds = p * (dob @ vf[:, :, k0:k1].transpose(-1, -2)
                      - di[:, :, q0:q1, None])
            dk[:, :, k0:k1] += ds.transpose(-1, -2) @ qf[:, :, q0:q1]
            dq[:, :, q0:q1] += ds @ kf[:, :, k0:k1]
    dq = (dq * scale).transpose(1, 2)
    dk = dk.view(B, Hkv, group, Lk, D).sum(2).transpose(1, 2)
    dv = dv.view(B, Hkv, group, Lk, D).sum(2).transpose(1, 2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_stats_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, visible: torch.Tensor,
                                scale: Optional[float] = None):
    """The stats kernel's math in PyTorch: per (query block, key block) an
    fp32 online softmax over the keys ``col < visible[b, h, row]``, masked
    probabilities set to 0, and each query block stopping at the largest
    count among its rows, in the bf16 kernel's tiles. Returns
    ``(o, m, l)``: the unnormalised output, fp32 [B, Lq, H, D], and the
    rows' max and sum, fp32 [B, H, Lq]. A row that sees no key keeps
    m = NEG_INF, l = 0 and o = 0. Each kv head serves its group of query
    heads (GQA) without being repeated."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = D ** -0.5
    group = H // Hkv
    # [B, Hkv, G, L, D]: query head h = hk * G + g reads kv head hk
    qf = q.float().reshape(B, Lq, Hkv, group, D).permute(0, 2, 3, 1, 4) \
        * scale
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    vis = visible.clamp(0, Lk).reshape(B, Hkv, group, Lq)
    o = torch.zeros(B, Hkv, group, Lq, D, device=q.device)
    m = torch.full((B, Hkv, group, Lq), NEG_INF, device=q.device)
    l = torch.zeros(B, Hkv, group, Lq, device=q.device)
    block_k = _tc_block_k(D)
    for q0 in range(0, Lq, _TC_BLOCK_Q):
        q1 = min(Lq, q0 + _TC_BLOCK_Q)
        seen_to = vis[..., q0:q1, None]
        mb, lb, ob = m[..., q0:q1], l[..., q0:q1], o[..., q0:q1, :]
        for k0 in range(0, int(seen_to.max()), block_k):
            k1 = min(Lk, k0 + block_k)
            s = qf[..., q0:q1, :] @ kf[..., k0:k1, :].transpose(-1, -2)
            seen = torch.arange(k0, k1, device=q.device) < seen_to
            s = torch.where(seen, s, NEG_INF)
            m_new = torch.maximum(mb, s.amax(dim=-1))
            p = torch.where(seen, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(mb - m_new)
            lb = lb * alpha + p.sum(dim=-1)
            ob = ob * alpha[..., None] + p @ vf[..., k0:k1, :]
            mb = m_new
        m[..., q0:q1], l[..., q0:q1], o[..., q0:q1, :] = mb, lb, ob
    o = o.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, D)
    return o, m.reshape(B, H, Lq), l.reshape(B, H, Lq)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None):
    """The forward that a backward needs: ``(o, lse)``, with each row's
    fp32 log-sum-exp [B, H, Lq]. The kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, float(scale), with_lse=True)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 return_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None):
    """``(dq, dk, dv)`` from the forward's inputs, ``o`` and ``lse`` and
    the output gradient ``do``. The dK/dV and dQ kernels for a CUDA
    tensor, the plain version for a CPU tensor."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _launch_bwd(q, k, v, o, lse, do, causal, float(scale))
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                     scale=scale)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = flash_attention_bwd(*ctx.saved_tensors, do, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 segment_ids: Optional[torch.Tensor] = None) -> bool:
    """Whether the flash kernels take these inputs, from their shapes,
    dtypes and options alone (no device is read): a head dim in {64, 128},
    q, k and v all fp32 or all bf16, and no ``segment_ids``. Any L is
    taken. Rows off 16-byte boundaries are a layout fault the launch
    raises on, not a shape the kernels decline."""
    return (segment_ids is None and q.shape[-1] in _HEAD_DIMS
            and q.dtype in _DTYPE_CODES and k.dtype == q.dtype
            and v.dtype == q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Flash attention, [B, L, H, D], GQA-aware, differentiable.

    A CUDA tensor goes to the Hopper kernels when ``kernel_takes`` holds,
    else to ``dense_attention`` (counted in ``dense_routes``), as the JAX
    package sends what its kernel does not tile. A CPU tensor runs the
    plain versions (``dense_attention`` when ``segment_ids`` is given, as
    the JAX package does off the TPU). Where no gradient is wanted
    (``torch.no_grad``, or no input requires one) only the forward runs,
    without the row statistics the backward needs."""
    global dense_routes
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda" and not kernel_takes(q, k, v, segment_ids):
        dense_routes += 1
        return dense_attention(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids)
    if segment_ids is not None:
        return dense_attention(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, float(scale))
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    return _launch(q, k, v, causal, float(scale))


def flash_attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          visible: torch.Tensor,
                          scale: Optional[float] = None):
    """Ring attention's block step, [B, L, H, D] in (K/V may carry fewer
    heads), ``(o, m, l)`` out: the unnormalised output, fp32
    [B, Lq, H, D], and the rows' max and sum, fp32 [B, H, Lq].

    ``visible`` is int32 [B, H, Lq]: key column ``c`` is seen by a row iff
    ``c < visible[b, h, row]``; a broadcast view (stride 0) is read as it
    is. A row that sees no key comes out with ``m == NEG_INF``, which a
    ring merge multiplies away (``exp(NEG_INF - m_new) == 0``); here its
    ``l`` and ``o`` are also 0. Lq and Lk may differ.

    A CUDA tensor goes to the stats kernel; shapes, types or strides it
    does not take raise. A CPU tensor runs the plain version. It defines
    no gradient: the ring that calls it has its own backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cuda":
        return _launch_stats(q, k, v, visible, float(scale))
    return flash_attention_stats_plain(q, k, v, visible, scale=scale)


def _check(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, L, H, D] with k.shape == "
                         f"v.shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Lq, H, D = q.shape
    _, Lk, Hkv, Dk = k.shape
    if k.shape[0] != B or Dk != D:
        raise ValueError("q and k/v differ in batch or head dim")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} kv heads")
    if causal and Lq != Lk:
        raise ValueError(f"causal flash attention needs Lq == Lk, got "
                         f"{Lq} and {Lk}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes float32 or bfloat16 for all of "
                        f"q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is not on {q.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a unit-stride head dim")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` [B, L, H, D] starts on a 16-byte
    boundary: its base address and its (batch, seq, head) strides, in
    bytes, divide by 16 (an axis of extent 1 is never stepped over)."""
    steps = [st * t.element_size() for st, n in
             zip(t.stride()[:3], t.shape[:3]) if n > 1]
    return t.data_ptr() % 16 == 0 and not any(s % 16 for s in steps)


def _check_rows_aligned(**ts):
    """The bf16 kernels copy rows in 16-byte chunks (``cp.async``), so each
    row of each tensor must start on a 16-byte boundary."""
    for name, t in ts.items():
        if not _rows_aligned(t):
            raise ValueError(
                f"{name}: the bf16 kernel needs rows on 16-byte boundaries, "
                f"got address {t.data_ptr():#x} and strides {t.stride()}")


def bwd_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * dO), fp32 [B, H, Lq] contiguous: the backward's
    plain reduction outside the kernels, as in Mosaic. The products are
    taken in place in a fp32 copy of o (the same values as multiplying two
    fp32 copies, with one copy fewer to write and read)."""
    prod = o.to(torch.float32, copy=True).mul_(do)
    return prod.sum(-1).transpose(1, 2).contiguous()


def _bwd_inputs(q, k, v, o, lse, do):
    """Check what the backward kernels take beyond ``_check``, before any
    kernel is loaded: dO and o like q, lse contiguous fp32 [B, H, Lq], and
    for bf16 every row of q, k and v on a 16-byte boundary (else raise).
    Returns dO, copied contiguous when autograd hands over one whose head
    dim is strided or, for bf16, whose rows are off 16-byte boundaries."""
    B, Lq, H, _ = q.shape
    for name, t in (("dO", do), ("o", o)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}: got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if lse.shape != (B, H, Lq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be contiguous fp32 [B, H, Lq] = "
                         f"{(B, H, Lq)} on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        _check_rows_aligned(q=q, k=k, v=v)
    if do.stride(-1) != 1 or (bf16 and not _rows_aligned(do)):
        do = do.contiguous()
    return do


def _strides(*ts) -> ctypes.Array:
    """(batch, seq, head) strides of each tensor, flat, for the kernels."""
    flat = [n for t in ts for n in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(q, k, v, causal: bool, scale: float, with_lse: bool = False):
    """Run the forward kernel; returns ``o``, or ``(o, lse)`` with the rows'
    fp32 log-sum-exp [B, H, Lq] when ``with_lse``."""
    global launches
    _check(q, k, v, causal)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q=q, k=k, v=v)
    lib = _load("flash_fwd")
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ray_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPE_CODES[q.dtype],
            B, Lq, Lk, H, Hkv, D, _strides(q, k, v, o), scale, int(causal),
            stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed with code {rc}")
    launches += 1
    return (o, lse) if with_lse else o


def _launch_bwd(q, k, v, o, lse, do, causal: bool, scale: float):
    """Run the dK/dV and dQ kernels; returns ``(dq, dk, dv)``."""
    global bwd_launches
    _check(q, k, v, causal)
    do = _bwd_inputs(q, k, v, o, lse, do)
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    di = bwd_di(o, do)
    lib = _load("flash_bwd")
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Lk, Hkv, D), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ray_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _DTYPE_CODES[q.dtype], B, Lq, Lk, H, Hkv, D,
            _strides(q, k, v, do, dq, dk, dv), scale, int(causal), stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd kernel launch failed with code {rc}")
    bwd_launches += 1
    return dq, dk, dv


def _launch_stats(q, k, v, visible, scale: float):
    """Run the stats kernel; returns ``(o, m, l)``."""
    global stats_launches
    _check(q, k, v, causal=False)
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if visible.shape != (B, H, Lq) or visible.dtype != torch.int32 or \
            visible.device != q.device:
        raise ValueError(f"visible must be int32 [B, H, Lq] = {(B, H, Lq)} "
                         f"on {q.device}, got {visible.dtype} "
                         f"{tuple(visible.shape)} on {visible.device}")
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q=q, k=k, v=v)
    lib = _load("flash_stats")
    o = torch.empty((B, Lq, H, D), dtype=torch.float32, device=q.device)
    m = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    l = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ray_flash_stats(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), visible.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), _DTYPE_CODES[q.dtype],
            B, Lq, Lk, H, Hkv, D,
            _strides(q, k, v, o, visible.transpose(1, 2)),  # [B, Lq, H]
            scale, stream)
    if rc != 0:
        raise RuntimeError(f"flash_stats kernel launch failed with code {rc}")
    stats_launches += 1
    return o, m, l


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the flash kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source_digest(name: str, csrc: Path = _CSRC) -> str:
    """The key of library ``name``'s build: a hash of ``<name>.cu`` and of
    every header in ``csrc`` (names and contents), so that editing any
    header a kernel may include rebuilds it."""
    digest = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return digest.hexdigest()[:16]


def build(name: str = "flash_fwd") -> Path:
    """Compile ``csrc/<name>.cu`` for sm_90a into ``_build/`` unless a
    library built from the same sources (``source_digest``) is there;
    returns its path. ptxas's report is kept beside it as
    ``<library>.log``."""
    if name not in KERNELS:
        raise ValueError(f"unknown kernel library {name!r}")
    source = _CSRC / f"{name}.cu"
    lib_path = _BUILD_DIR / f"{name}_{source_digest(name)}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {name}.cu:"
                           f"\n{proc.stdout}\n{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


_ARGTYPES = {
    "flash_fwd": ("ray_flash_fwd", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                  + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                     ctypes.c_int, ctypes.c_void_p]),
    "flash_bwd": ("ray_flash_bwd", [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                  + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                     ctypes.c_int, ctypes.c_void_p]),
    "flash_stats": ("ray_flash_stats", [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 7
                    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                       ctypes.c_void_p]),
}


def _load(name: str):
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            fn_name, argtypes = _ARGTYPES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]
