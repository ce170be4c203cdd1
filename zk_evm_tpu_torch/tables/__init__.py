from .logic import LogicStark

__all__ = ["LogicStark"]
