"""Prover-input queues.

Twin of zk_evm's evm_arithmetization/src/generation/rlp.rs and
state.rs:781-801 (withdrawals + GER queues). All queues are reversed so
the next value pops off the end.
"""

from __future__ import annotations

U256_MAX = (1 << 256) - 1


def all_rlp_prover_inputs_reversed(signed_txns) -> list[int]:
    """Per txn: [len, 32-byte big-endian chunks (last one right-padded)],
    whole list reversed (rlp.rs:3-25)."""
    inputs: list[int] = []
    for txn in signed_txns:
        txn = bytes(txn)
        inputs.append(len(txn))
        for i in range(0, len(txn), 32):
            chunk = txn[i:i + 32]
            chunk = chunk + b"\x00" * (32 - len(chunk))
            inputs.append(int.from_bytes(chunk, "big"))
    inputs.reverse()
    return inputs


def all_withdrawals_prover_inputs_reversed(withdrawals) -> list[int]:
    """[addr0, amount0, ..., U256_MAX, U256_MAX] reversed
    (state.rs:781-791). Addresses may be 20-byte bytes or ints."""
    out: list[int] = []
    for addr, amount in withdrawals:
        if isinstance(addr, (bytes, bytearray)):
            addr = int.from_bytes(addr, "big")
        out.append(addr)
        out.append(int(amount))
    out.append(U256_MAX)
    out.append(U256_MAX)
    out.reverse()
    return out
