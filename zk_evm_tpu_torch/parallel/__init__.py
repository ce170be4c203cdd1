from .blocks import block_runs, reset_block_runs, run_blocks
from .sharded import Mesh, commit_cap, make_mesh, sharded_commit_cap

__all__ = ["Mesh", "block_runs", "commit_cap", "make_mesh",
           "reset_block_runs", "run_blocks", "sharded_commit_cap"]
