from .attention import (dense_attention, flash_attention,
                        flash_attention_plain)
from .layers import (
    apply_rope,
    cross_entropy_loss,
    rms_norm,
    rope_frequencies,
    swiglu,
)
from .quant import Q8, mm, quantize_array, quantize_params, quantized_nbytes

__all__ = [
    "dense_attention", "flash_attention", "flash_attention_plain",
    "rms_norm", "rope_frequencies", "apply_rope", "swiglu",
    "cross_entropy_loss", "Q8", "mm", "quantize_array", "quantize_params",
    "quantized_nbytes",
]
