"""Weight-only int8 quantization (port of ``ray_tpu/ops/quant.py``).

Symmetric per-output-channel scales. The dequantizing matmul stays plain
PyTorch, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


class Q8(NamedTuple):
    """An int8-quantized weight: ``w`` int8 [..., out], ``s`` scales
    broadcastable over the output axis, in the original dtype."""

    w: torch.Tensor
    s: torch.Tensor


def quantize_array(w: torch.Tensor) -> Q8:
    """Symmetric per-output-channel (last axis) int8 quantization."""
    wf = w.float()
    amax = wf.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return Q8(q, scale.to(w.dtype))


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """``x @ w`` for plain and Q8 weights; the weight is cast to the
    activation's dtype."""
    if isinstance(w, Q8):
        return (x @ w.w.to(x.dtype)) * w.s
    return x @ (w.to(x.dtype) if w.dtype != x.dtype else w)


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "lm_head")


def quantize_params(params: dict) -> dict:
    """Quantize a Llama-shaped tree's projection weights. Embeddings and
    norms stay as they are. Returns a new tree; the input is untouched."""
    out = dict(params)
    if "lm_head" in out:
        out["lm_head"] = quantize_array(out["lm_head"])
    if "layers" in out:
        new_layers = []
        for layer in out["layers"]:
            nl = dict(layer)
            for k in _QUANT_KEYS:
                if k in nl and not isinstance(nl[k], Q8):
                    nl[k] = quantize_array(nl[k])
            new_layers.append(nl)
        out["layers"] = new_layers
    return out


def tree_leaves(tree: Any):
    """The tensor and ``Q8`` leaves of a tree of dicts, lists and tuples,
    in order (dicts in insertion order)."""
    if isinstance(tree, (Q8, torch.Tensor)):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)


def quantized_nbytes(params: Any) -> int:
    """Total parameter bytes (Q8 leaves count their int8 + scale)."""
    total = 0
    for leaf in tree_leaves(params):
        if isinstance(leaf, Q8):
            total += leaf.w.numel() + leaf.s.numel() * leaf.s.element_size()
        else:
            total += leaf.numel() * leaf.element_size()
    return total
