from .core import TrieInputs, GenerationInputs

__all__ = ["TrieInputs", "GenerationInputs"]
