"""Entry points of the port, the twins of the JAX package's
`__graft_entry__.py`.

- `entry()`: the trace commitment (LDE + Poseidon-Merkle cap), the
  prover's bottleneck operation, as a function and its arguments.
- `dryrun_multichip(n)`: the commitment and a three-table proof over an
  n-entry mesh, each held to the single-device result: the
  determinism contract that keeps the Fiat-Shamir transcript the same at
  any sharding.

    from zk_evm_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()                  # on the card; entry("cpu") too
    cap = fn(*args)                     # (4, 4) int64 digests
    dryrun_multichip(8)                 # an 8-entry CPU mesh
    dryrun_multichip(2, device_type="cuda")  # raises with fewer cards
    dryrun_multichip(2, mesh=Mesh(["cuda:0"] * 2))  # one card, twice
"""

from __future__ import annotations

import numpy as np
import torch

from .field import GF, host
from .parallel import Mesh, commit_cap, make_mesh, sharded_commit_cap
from .stark.prover import resolve_device


def entry(device=None):
    """(fn, args): `fn(*args)` is the Poseidon-Merkle cap (cap height 2)
    of 16 random polys of 256 values (numpy seed 0) as an int64 tensor,
    on the card unless `device` says otherwise."""
    rng = np.random.default_rng(0)
    values = rng.integers(0, host.P, size=(16, 256), dtype=np.uint64)
    gf = GF.from_u64(values, resolve_device(device))

    def fn(v: torch.Tensor) -> torch.Tensor:
        return commit_cap(GF(v), cap_height=2).v

    return fn, (gf.v,)


def dryrun_multichip(n_devices: int, device_type: str = "cpu",
                     mesh: Mesh | None = None) -> None:
    """Check, over a mesh of `n_devices` entries, against one device:
    the sharded cap at (max(2n, 8), 64), numpy seed 1, cap height 2; the
    three-table MemBefore -> Memory -> MemAfter `prove_all` over the
    mesh at a tiny config, byte for byte; and `verify_all` of the mesh
    proof. Raises on any difference.

    The mesh is `make_mesh(n_devices, device_type)`, which raises when
    the host has fewer cards than `n_devices`, unless `mesh` (of
    `n_devices` entries) is given: a mesh that names a card more than
    once is run only on purpose, by passing it.

    The JAX dryrun's last block, the windowed jit quotient
    (`ZK_JIT_QUOTIENT`), is not ported: the port's quotient has one
    eager path."""
    from .stark import FriConfig, StarkConfig, prove_all, verify_all
    from .stark.serialization import proof_to_json
    from .tables import all_stark as ast
    from .tables.memory_chain import chain_traces
    from .tables.segments import Segment

    if mesh is None:
        mesh = make_mesh(n_devices, device_type=device_type)
    if len(mesh) != n_devices:
        raise ValueError(f"mesh of {len(mesh)} entries for "
                         f"dryrun_multichip({n_devices})")
    dev = mesh[0]

    rng = np.random.default_rng(1)
    polys = max(2 * n_devices, 8)
    values = rng.integers(0, host.P, size=(polys, 64), dtype=np.uint64)
    gf = GF.from_u64(values, dev)
    got = sharded_commit_cap(gf, mesh, cap_height=2).to_u64()
    want = commit_cap(gf, cap_height=2).to_u64()
    if got.tolist() != want.tolist():
        raise AssertionError("sharded cap differs from single-device cap")
    print(f"dryrun_multichip({n_devices}): sharded commit cap matches "
          f"single-device cap ({got.shape[0]} digests)")

    cfg = StarkConfig(
        security_bits=1,
        fri_config=FriConfig(rate_bits=1, cap_height=1,
                             proof_of_work_bits=0, num_query_rounds=2,
                             arity_bits=2, final_poly_bits=2))
    mem_before = [((0, Segment.MainMemory, 64 + i), i * 7 + 1)
                  for i in range(5)]
    traces = chain_traces(mem_before)
    ctls = ast.all_cross_table_lookups()
    starks = ast.all_starks()
    optional = tuple(i for i, t in enumerate(traces) if t is None)
    a1 = prove_all(starks, traces, ctls, cfg, device=dev)
    a2 = prove_all(starks, traces, ctls, cfg, mesh=mesh)
    if proof_to_json(a1) != proof_to_json(a2):
        raise AssertionError("sharded AllStark proof differs from "
                             "single-device proof")
    verify_all(starks, a2, ctls, cfg, optional_tables=optional, device=dev)
    print(f"dryrun_multichip({n_devices}): 3-table AllStark with the "
          "memory-continuation CTL chain bit-identical over the mesh "
          "and verified")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ran:", tuple(out.shape))
