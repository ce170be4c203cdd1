"""Block intervals: single block, bounded range, or follow-from.

Twin of the reference's zero/src/block_interval.rs BlockInterval:
constructed from (start, optional end) block ids resolved through the
provider, streamed as `(block_number, is_last)` pairs; follow-from
intervals poll the provider's latest block with a block-time sleep.
"""

from __future__ import annotations

import time
from dataclasses import dataclass


@dataclass(frozen=True)
class BlockInterval:
    start: int
    end: int | None = None      # inclusive; None => follow-from

    @classmethod
    def new(cls, provider, start_block, end_block=None) -> "BlockInterval":
        """block_interval.rs:79-108: end==start -> single; end given ->
        inclusive bounded range (must be > start); end None ->
        follow-from."""
        start_num = provider.block_to_num(start_block)
        if end_block is None:
            return cls(start_num, None)
        if end_block == start_block:
            return cls(start_num, start_num)
        end_num = provider.block_to_num(end_block)
        if end_num <= start_num:
            raise ValueError(f"invalid block interval range "
                             f"({start_num}..{end_num})")
        return cls(start_num, end_num)

    @classmethod
    def parse(cls, text: str) -> "BlockInterval":
        """'N', 'N..M' (inclusive), or 'N..' (follow-from)."""
        if ".." in text:
            lo, hi = text.split("..", 1)
            return cls(int(lo, 0), int(hi, 0) if hi else None)
        n = int(text, 0)
        return cls(n, n)

    @property
    def is_bounded(self) -> bool:
        return self.end is not None

    def get_start_block(self) -> int:
        return self.start

    def bounded(self):
        """Iterate (block_number, is_last) (into_bounded_stream)."""
        if self.end is None:
            raise ValueError("cannot bound a follow-from interval")
        for n in range(self.start, self.end + 1):
            yield n, n == self.end

    def unbounded(self, provider, block_time_ms: float = 2000.0,
                  sleep=time.sleep):
        """Follow the chain head (into_unbounded_stream): yields
        (block_number, False) forever, sleeping one block time when
        caught up."""
        if self.end is not None:
            raise ValueError("cannot follow a bounded interval")
        current = self.start
        yield current, False
        while True:
            latest = provider.latest_block_number()
            if current < latest:
                current += 1
                yield current, False
            else:
                sleep(block_time_ms / 1e3)

    def __str__(self) -> str:
        if self.end is None:
            return f"{self.start}.."
        if self.end == self.start:
            return str(self.start)
        return f"{self.start}..{self.end}"
