from .attention import (dense_attention, flash_attention,
                        flash_attention_bwd, flash_attention_bwd_plain,
                        flash_attention_fwd, flash_attention_plain,
                        flash_attention_stats, flash_attention_stats_plain)
from .chunked_xent import chunked_cross_entropy
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
    "flash_attention_fwd", "flash_attention_bwd",
    "flash_attention_bwd_plain", "flash_attention_stats",
    "flash_attention_stats_plain", "chunked_cross_entropy",
    "rms_norm", "rope_frequencies", "apply_rope", "swiglu",
    "cross_entropy_loss", "Q8", "mm", "quantize_array", "quantize_params",
    "quantized_nbytes",
]
