"""Bring a JAX parameter tree into the port, and read the port's back.

``params_from_numpy`` takes the tree after its leaves have become numpy
arrays (a JAX ``Q8`` leaf as a ``(w, s)`` pair) and returns the port's
tree on ``device``, with the same names and ``[in, out]`` layout.
``params_to_numpy`` goes the other way, and ``trainable`` hands a tree's
leaves to an optimizer. Any nesting of dicts and lists carries across as
it is (a Mixtral layer's ``experts`` dict), and each leaf keeps its own
dtype unless ``dtype`` is given: a bf16 Mixtral's fp32 ``router`` and a
bf16 ViT's fp32 ``head`` stay fp32.

A JAX bf16 array converts to a numpy array whose dtype is ``bfloat16``
from ``ml_dtypes``; ``torch.from_numpy`` refuses it. Such an array is
recognised by its dtype's name and its bits are reinterpreted through
uint16, so the conversion is exact and needs no ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..ops.quant import Q8, tree_leaves


def _tensor_from_numpy(a: np.ndarray, device=None,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One array to a tensor on ``device``; ``dtype`` casts floats only."""
    device = resolve_device(device)
    a = np.array(a, order="C")  # a writable copy; JAX's views are not
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device=None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Convert a tree of dicts, lists and numpy arrays, with each quantized
    weight as a ``(w, s)`` pair, into the port's tree of tensors and
    ``Q8`` leaves."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if isinstance(node, tuple) and len(node) == 2:
            w, s = node
            return Q8(_tensor_from_numpy(w, device),
                      _tensor_from_numpy(s, device, dtype))
        if isinstance(node, np.ndarray):
            return _tensor_from_numpy(node, device, dtype)
        raise TypeError(f"unsupported leaf {type(node)}")

    return conv(tree)


def trainable(tree: Any) -> List[torch.Tensor]:
    """Make every floating-point tensor leaf require a gradient and return
    the leaves in tree order, for ``torch.optim``. ``Q8`` leaves are left
    as they are: their int8 weights are not trained."""
    leaves = [t for t in tree_leaves(tree)
              if isinstance(t, torch.Tensor) and t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def params_to_numpy(tree: Any) -> Any:
    """The port's tree as numpy arrays on the host, detached: floating
    leaves as float32 (which holds a bf16 value exactly), others in their
    own type, each ``Q8`` leaf as a ``(w, s)`` pair."""
    def conv(node):
        if isinstance(node, Q8):
            return (conv(node.w), conv(node.s))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        if isinstance(node, torch.Tensor):
            t = node.detach().cpu()
            return (t.float() if t.is_floating_point() else t).numpy()
        raise TypeError(f"unsupported leaf {type(node)}")

    return conv(tree)
