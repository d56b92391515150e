"""Attention: the Hopper flash-attention forward kernel and its plain
versions. Layout throughout: [B, L, H, D]; K/V may carry fewer heads (GQA).

Port of ``ray_tpu/ops/attention.py``:
  * ``flash_attention`` launches ``csrc/flash_fwd.cu`` for a CUDA tensor
    (or raises) and runs ``flash_attention_plain`` for a CPU tensor. The
    kernel replaces ``_flash_attention_bhld`` (``_flash_kernel``) and the
    forward half of ``_tpu_flash`` (the Mosaic flash kernel); the source
    note in the ``.cu`` file says what bounds it.
  * ``flash_attention_plain`` is the same blockwise fp32 online softmax in
    PyTorch. The CPU tests run it, and the chip check holds the kernel
    against it; nothing on the CUDA path calls it.
  * ``dense_attention`` is the JAX package's oracle.

The kernel is built at its first CUDA use with ``nvcc`` into
``ray_tpu_torch/_build/``, keyed by a hash of its source, and loaded with
``ctypes``. A failed build raises.
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
_SOURCE = _PKG / "csrc" / "flash_fwd.cu"
_BUILD_DIR = _PKG / "_build"
_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches made by ``flash_attention``; a run that resets it and
#: reads it after shows that its path went through the kernel.
launches = 0

_lib = None
_lib_lock = threading.Lock()


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
                          block_q: int = 64, block_k: int = 32
                          ) -> torch.Tensor:
    """The kernel's math in PyTorch: per (query block, key block) an fp32
    online softmax, masked probabilities set to 0, causal block skipping,
    any L (the last blocks are short), output divided by max(l, 1e-30)
    and cast to q's dtype."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
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
        out[:, :, q0:q0 + nq] = acc / l.clamp(min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Forward flash attention, [B, L, H, D], GQA-aware.

    A CUDA tensor goes to the Hopper kernel; shapes, types or options it
    does not take raise. A CPU tensor runs ``flash_attention_plain``
    (``dense_attention`` when ``segment_ids`` is given, as the JAX
    package does off the TPU)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type != "cuda":
        if segment_ids is not None:
            return dense_attention(q, k, v, causal=causal, scale=scale,
                                   segment_ids=segment_ids)
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids are not supported by the CUDA flash kernel")
    return _launch(q, k, v, causal, float(scale))


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


def _launch(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    global launches
    _check(q, k, v, causal)
    lib = _load()
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    o = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ray_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               o.data_ptr(), _DTYPE_CODES[q.dtype], B, Lq,
                               Lk, H, Hkv, D, strides, scale, int(causal),
                               stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed with code {rc}")
    launches += 1
    return o


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit to build the flash kernel")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile ``csrc/flash_fwd.cu`` for sm_90a into ``_build/`` unless a
    library built from the same source is there; returns its path."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"flash_fwd_{tag}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    (_BUILD_DIR / f"flash_fwd_{tag}.log").write_text(proc.stderr)
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ray_flash_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p]
            lib.ray_flash_fwd.restype = ctypes.c_int
            _lib = lib
    return _lib
