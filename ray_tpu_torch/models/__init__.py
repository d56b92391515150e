from .llama import (
    generate_sample,
    LLAMA3_1B,
    LLAMA3_8B,
    LLAMA_DEBUG,
    LlamaConfig,
    forward,
    forward_hidden,
    generate_greedy,
    init_params,
)

from .convert import params_from_numpy
from .engine import GenerationEngine

__all__ = [
    "LlamaConfig", "LLAMA3_8B", "LLAMA3_1B", "LLAMA_DEBUG", "init_params",
    "forward", "forward_hidden", "generate_greedy", "generate_sample",
    "GenerationEngine", "params_from_numpy",
]
