"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``'s compute tier.

The serving, training, sequence-parallel, sharded and MoE slices:
Llama-family, Mixtral (MoE) and ViT model code (``models``, each with a
differentiable forward and ``loss_fn``), its ops (``ops``, with
hand-written Hopper flash-attention forward, backward and ring-step
kernels under ``csrc/``), the continuous-batching engine and the LLM
server (``serve.llm``), and the mesh, collectives, FSDP/TP sharding,
expert parallelism, ring attention and Ulysses (``parallel``). A training step is ``loss_fn``, autograd and
``torch.optim.AdamW`` over ``models.trainable(params)``. It imports
``torch`` and ``numpy`` only; the JAX package ``ray_tpu`` stays the
reference the tests hold this one to.

Entry points that build tensors take ``device=`` and default to CUDA;
without a GPU they raise unless the caller asks for ``device="cpu"``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
