"""ray_tpu_torch: the PyTorch/CUDA port of ``ray_tpu``'s compute tier.

The serving slice: Llama-family model code (``models``), its ops
(``ops``, with a hand-written Hopper flash-attention kernel under
``csrc/``), the continuous-batching engine and the LLM server
(``serve.llm``). It imports ``torch`` and ``numpy`` only; the JAX
package ``ray_tpu`` stays the reference the tests hold this one to.

Entry points that build tensors take ``device=`` and default to CUDA;
without a GPU they raise unless the caller asks for ``device="cpu"``.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
