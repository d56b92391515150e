from .llama import (
    LLAMA3_1B,
    LLAMA3_8B,
    LLAMA_DEBUG,
    LlamaConfig,
    flops_per_token,
    forward,
    forward_hidden,
    generate_greedy,
    generate_sample,
    init_params,
    loss_fn,
    next_token_targets,
)

from . import mixtral, vit
from .convert import params_from_numpy, params_to_numpy, trainable
from .engine import GenerationEngine
from .mixtral import (
    MIXTRAL_8X7B,
    MIXTRAL_DEBUG,
    MixtralConfig,
    mixtral_shardings,
)
from .mixtral import generate_greedy as mixtral_generate_greedy
from .paged import PagedEngine
from .speculative import generate_speculative, truncated_draft

__all__ = [
    "LlamaConfig", "LLAMA3_8B", "LLAMA3_1B", "LLAMA_DEBUG", "init_params",
    "forward", "forward_hidden", "loss_fn", "next_token_targets",
    "flops_per_token", "generate_greedy", "generate_sample",
    "GenerationEngine", "PagedEngine", "generate_speculative",
    "truncated_draft", "params_from_numpy", "params_to_numpy", "trainable",
    "mixtral", "MixtralConfig", "MIXTRAL_8X7B", "MIXTRAL_DEBUG",
    "mixtral_shardings", "mixtral_generate_greedy", "vit",
]
