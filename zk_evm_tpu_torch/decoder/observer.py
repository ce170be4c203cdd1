"""Observer hooks for the trace decoder.

Counterpart of the reference's observer API (trace_decoder/src/
observer.rs:11-26): a callback invoked after every batch with the
post-execution state/transaction/receipt tries, used to collect
intermediate tries for debugging (the trie_diff flow) and metadata.
Snapshots are persistent-trie handles, so collecting them is O(1) —
no copy is taken unless the caller mutates afterwards.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class Observer:
    """No-op base (the reference's DummyObserver, observer.rs:84-101)."""

    def collect_tries(self, block: int, batch: int, state, storage,
                      transaction_trie, receipt_trie) -> None:
        pass


DummyObserver = Observer


@dataclass
class TriesObserverElement:
    """Post-batch tries as the decoder sees them
    (observer.rs:31-40)."""
    block: int
    batch: int
    state: object          # state trie snapshot (hashed-addr -> rlp)
    storage: dict          # hashed-addr -> storage trie snapshot
    transaction_trie: object
    receipt_trie: object


@dataclass
class TriesObserver(Observer):
    """Collects the intermediate tries after every batch
    (observer.rs:42-79)."""
    data: list = field(default_factory=list)

    def collect_tries(self, block: int, batch: int, state, storage,
                      transaction_trie, receipt_trie) -> None:
        self.data.append(TriesObserverElement(
            block=block, batch=batch, state=state, storage=storage,
            transaction_trie=transaction_trie,
            receipt_trie=receipt_trie))
