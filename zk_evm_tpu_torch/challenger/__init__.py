from .challenger import Challenger

__all__ = ["Challenger"]
