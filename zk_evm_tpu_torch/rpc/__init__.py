"""RPC frontend: providers, fetchers, block intervals.

Twin of the reference's zero/src/{rpc,provider,block_interval}.rs —
everything needed to turn a live (or canned) JSON-RPC endpoint into
BlockProverInput objects for the decoder."""

from .block_interval import BlockInterval
from .fetch import (consolidate_hashes, fetch_other_block_data,
                    fetch_previous_block_hashes,
                    jerigon_block_prover_input,
                    native_block_prover_input)
from .provider import (CachedProvider, HttpTransport, MockTransport,
                       RetryTransport, RpcError, TransportError)

__all__ = [
    "BlockInterval", "CachedProvider", "HttpTransport", "MockTransport",
    "RetryTransport", "RpcError", "TransportError", "consolidate_hashes",
    "fetch_other_block_data", "fetch_previous_block_hashes",
    "jerigon_block_prover_input", "native_block_prover_input",
]
