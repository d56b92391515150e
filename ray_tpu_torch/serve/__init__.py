from .llm import LLMServer, build_llm_app

__all__ = ["LLMServer", "build_llm_app"]
