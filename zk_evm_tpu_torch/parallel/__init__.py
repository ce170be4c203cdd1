from .sharded import Mesh, commit_cap, make_mesh, sharded_commit_cap

__all__ = ["Mesh", "commit_cap", "make_mesh", "sharded_commit_cap"]
