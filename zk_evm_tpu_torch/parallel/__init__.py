from .sharded import commit_cap

__all__ = ["commit_cap"]
