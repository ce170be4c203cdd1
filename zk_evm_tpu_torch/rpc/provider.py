"""JSON-RPC provider stack: transport, retry, block cache.

Twin of the reference's zero/src/provider.rs (CachedProvider: LRU block
caches + request semaphore) and zero/src/rpc/retry.rs (RetryPolicy /
build_http_retry_provider). The transport is a plain callable
`(method, params) -> result`, so tests inject canned responses and the
HTTP transport is one implementation rather than a type parameter.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from collections import OrderedDict

CACHE_SIZE = 1024            # provider.rs:13 CACHE_SIZE
MAX_PARALLEL_REQUESTS = 128  # provider.rs:14 MAX_NUMBER_OF_PARALLEL_REQUESTS


class RpcError(RuntimeError):
    """A JSON-RPC level error response."""

    def __init__(self, method, error):
        super().__init__(f"{method}: {error}")
        self.method = method
        self.error = error


class TransportError(RuntimeError):
    """A transport-level failure (connection, HTTP status, bad JSON)."""


class HttpTransport:
    """Plain HTTP JSON-RPC transport (urllib; no external deps)."""

    def __init__(self, url: str, timeout: float = 30.0):
        self.url = url
        self.timeout = timeout
        self._id = 0
        self._lock = threading.Lock()

    def _next_id(self) -> int:
        with self._lock:
            self._id += 1
            return self._id

    def __call__(self, method: str, params):
        body = json.dumps({"jsonrpc": "2.0", "id": self._next_id(),
                           "method": method, "params": params}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except (OSError, ValueError) as e:
            raise TransportError(f"{method}: {e}") from e
        if "error" in payload and payload["error"] is not None:
            raise RpcError(method, payload["error"])
        return payload.get("result")


class RetryTransport:
    """Retry wrapper with fixed backoff (retry.rs RetryPolicy: a
    transport error retries up to max_retries with a constant backoff;
    RPC-level errors do not retry)."""

    def __init__(self, inner, max_retries: int = 3,
                 backoff_ms: float = 0.0, sleep=time.sleep):
        self.inner = inner
        self.max_retries = max_retries
        self.backoff_s = backoff_ms / 1e3
        self._sleep = sleep

    def __call__(self, method: str, params):
        attempt = 0
        while True:
            try:
                return self.inner(method, params)
            except TransportError:
                if attempt >= self.max_retries:
                    raise
                attempt += 1
                if self.backoff_s:
                    self._sleep(self.backoff_s)


class MockTransport:
    """Canned-response transport for tests and offline replay.

    Responses are keyed by (method, json(params)); a handler callable
    may be registered per method instead. Every request is recorded.
    """

    def __init__(self):
        self.canned: dict[tuple[str, str], object] = {}
        self.handlers: dict[str, object] = {}
        self.requests: list[tuple[str, object]] = []

    def expect(self, method: str, params, result) -> None:
        self.canned[(method, json.dumps(params, sort_keys=True))] = result

    def handle(self, method: str, fn) -> None:
        self.handlers[method] = fn

    def __call__(self, method: str, params):
        self.requests.append((method, params))
        key = (method, json.dumps(params, sort_keys=True))
        if key in self.canned:
            return self.canned[key]
        if method in self.handlers:
            return self.handlers[method](params)
        raise TransportError(f"no canned response for {method} {params}")


def _to_block_number(provider, block_id) -> int:
    if isinstance(block_id, int):
        return block_id
    if isinstance(block_id, str) and block_id.startswith("0x") \
            and len(block_id) == 66:
        block = provider.get_block_by_hash(block_id)
        if block is None:
            raise KeyError(f"block not found {block_id}")
        return int(block["number"], 16)
    if isinstance(block_id, str):
        if block_id == "latest":
            return provider.latest_block_number()
        return int(block_id, 16 if block_id.startswith("0x") else 10)
    raise TypeError(f"bad block id {block_id!r}")


class CachedProvider:
    """Block-caching provider (provider.rs CachedProvider): LRU caches
    keyed by number and by hash, a bounded-concurrency semaphore, and
    `raw_request` passthrough for tracer/witness endpoints.

    Only blocks fetched WITHOUT full transactions are cached
    (provider.rs:105-135 caches BlockTransactionsKind::Hashes only).
    """

    def __init__(self, transport, rpc_type: str = "jerigon"):
        assert rpc_type in ("jerigon", "native")
        self.transport = transport
        self.rpc_type = rpc_type
        self._by_number: OrderedDict[int, dict] = OrderedDict()
        self._by_hash: OrderedDict[str, int] = OrderedDict()
        self._lock = threading.Lock()
        self._sem = threading.BoundedSemaphore(MAX_PARALLEL_REQUESTS)

    def raw_request(self, method: str, params):
        with self._sem:
            return self.transport(method, params)

    def _cache_put(self, block: dict) -> None:
        num = int(block["number"], 16)
        with self._lock:
            self._by_number[num] = block
            self._by_number.move_to_end(num)
            while len(self._by_number) > CACHE_SIZE:
                self._by_number.popitem(last=False)
            h = block.get("hash")
            if h:
                self._by_hash[h.lower()] = num
                self._by_hash.move_to_end(h.lower())
                while len(self._by_hash) > CACHE_SIZE:
                    self._by_hash.popitem(last=False)

    def get_block(self, number: int, full_txns: bool = False):
        """eth_getBlockByNumber; header-only responses are cached."""
        if not full_txns:
            with self._lock:
                blk = self._by_number.get(number)
            if blk is not None:
                return blk
        blk = self.raw_request("eth_getBlockByNumber",
                               [hex(number), full_txns])
        if blk is not None and not full_txns:
            self._cache_put(blk)
        return blk

    def get_block_by_hash(self, block_hash: str, full_txns: bool = False):
        with self._lock:
            num = self._by_hash.get(block_hash.lower())
        if num is not None and not full_txns:
            return self.get_block(num)
        blk = self.raw_request("eth_getBlockByHash",
                               [block_hash, full_txns])
        if blk is not None and not full_txns:
            self._cache_put(blk)
        return blk

    def latest_block_number(self) -> int:
        return int(self.raw_request("eth_blockNumber", []), 16)

    def chain_id(self) -> int:
        return int(self.raw_request("eth_chainId", []), 16)

    def block_to_num(self, block_id) -> int:
        """BlockId (number | hex hash | 'latest') -> block number
        (block_interval.rs BlockInterval::block_to_num)."""
        return _to_block_number(self, block_id)
