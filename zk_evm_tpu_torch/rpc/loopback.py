"""A JSON-RPC node on 127.0.0.1 that answers from a transport, and a toy
block for the native fetcher.

`serve_loopback(transport)` starts an `http.server` thread that hands
each JSON-RPC request to `transport(method, params)` (a `MockTransport`,
say) and returns its result, or a JSON-RPC error when it raises; an
`HttpTransport` pointed at the returned URL then goes through real HTTP
without leaving the host. `toy_native_block()` builds the canned node of
one block with one transfer (the JAX package's
`tests/test_rpc.py::test_native_fetch_builds_witness_from_proofs`):
`eth_getProof` answered from a `StateMpt`, the prestate and diff
tracers, and an `eth_call` that fails, so the fetcher falls back to
fetching the previous hashes block by block.

    node, facts = toy_native_block()
    server, url = serve_loopback(node)
    obj = native_block_prover_input(CachedProvider(HttpTransport(url)), 1,
                                    checkpoint_block_number=0)
    server.shutdown()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..mpt import Nibbles
from ..mpt.world import Account, StateMpt
from ..native import keccak256
from .provider import MockTransport, TransportError


def serve_loopback(transport):
    """(server, url): a JSON-RPC server on 127.0.0.1 at a free port,
    serving in a daemon thread; stop it with `server.shutdown()`."""

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            req = json.loads(self.rfile.read(
                int(self.headers["Content-Length"])))
            reply = {"jsonrpc": "2.0", "id": req.get("id")}
            try:
                reply["result"] = transport(req["method"], req["params"])
            except Exception as e:              # the node's error reply
                reply["error"] = {"code": -32000, "message": str(e)}
            body = json.dumps(reply).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def toy_native_block():
    """(node, facts): a MockTransport answering every request the native
    fetcher makes for block 1 (checkpoint block 0), and the facts a
    decoded result must show: the pre-state root, the sender, its
    storage root, and its balance and nonce after the transfer."""
    sender = bytes.fromhex("2c7536e3605d9c16a7a3d7b1898e529396a65c23")
    miner = bytes.fromhex("00000000000000000000000000000000000dead0")
    state = StateMpt()
    state.set_account(sender, Account(balance=10**18, nonce=1))
    state.set_storage(sender, 1, 42)
    state.set_account(miner, Account(balance=5))

    hsender = "0x" + sender.hex()
    hminer = "0x" + miner.hex()
    root = state.root()

    def get_proof(params):
        addr, keys, _blk = params
        a = bytes.fromhex(addr[2:])
        akey = Nibbles.from_bytes(keccak256(a))
        storage_root = state.storage_root(a)
        sp = []
        st = state.storage.get(keccak256(a))
        for k in keys:
            skey = Nibbles.from_bytes(
                keccak256(int(k, 16).to_bytes(32, "big")))
            proof = st.get_proof(skey) if st else []
            sp.append({"key": k,
                       "proof": ["0x" + p.hex() for p in proof]})
        return {"accountProof": ["0x" + p.hex()
                                 for p in state.trie.get_proof(akey)],
                "storageHash": "0x" + storage_root.hex(),
                "storageProof": sp}

    def no_eth_call(params):
        raise TransportError("no eth_call")

    txh = "0x" + "77" * 32
    mt = MockTransport()
    mt.handle("eth_getProof", get_proof)
    mt.expect("eth_chainId", [], "0x1")
    blk1 = {
        "number": "0x1", "hash": "0x" + "22" * 32,
        "miner": hminer, "timestamp": "0x10", "difficulty": "0x0",
        "mixHash": "0x" + "33" * 32, "gasLimit": "0x1c9c380",
        "gasUsed": "0x5208", "baseFeePerGas": "0x7",
        "logsBloom": "0x" + "00" * 256,
        "parentBeaconBlockRoot": "0x" + "44" * 32,
        "blobGasUsed": "0x0", "excessBlobGas": "0x0",
        "stateRoot": "0x" + "55" * 32,
        "transactions": [
            {"hash": txh, "raw": "0xc0"},
        ],
    }
    mt.expect("eth_getBlockByNumber", ["0x1", True], blk1)
    mt.expect("eth_getBlockByNumber", ["0x1", False],
              {k: v for k, v in blk1.items() if k != "transactions"})
    mt.expect("eth_getBlockByNumber", ["0x0", False],
              {"number": "0x0", "hash": "0x" + "66" * 32,
               "stateRoot": "0x" + root.hex()})
    mt.expect("eth_getTransactionReceipt", [txh],
              {"status": "0x1", "cumulativeGasUsed": "0x5208",
               "logsBloom": "0x" + "00" * 256, "logs": [],
               "type": "0x2", "gasUsed": "0x5208"})
    mt.expect("debug_traceTransaction",
              [txh, {"tracer": "prestateTracer",
                     "tracerConfig": {"diffMode": False}}],
              {hsender: {"balance": "0xde0b6b3a7640000", "nonce": 1,
                         "storage": {"0x1": "0x2a"}},
               hminer: {"balance": "0x5"}})
    mt.expect("debug_traceTransaction",
              [txh, {"tracer": "prestateTracer",
                     "tracerConfig": {"diffMode": True}}],
              {"pre": {hsender: {"balance": "0xde0b6b3a7640000"}},
               "post": {hsender: {"balance": "0xde0b6b000000000",
                                  "nonce": 2,
                                  "storage": {"0x1": "0x2b"}}}})
    # eth_call for prev hashes fails -> per-block fallback
    mt.handle("eth_call", no_eth_call)
    facts = {"root": root, "sender": sender,
             "storage_root": state.storage_root(sender),
             "balance": 0xde0b6b000000000, "nonce": 2}
    return mt, facts
