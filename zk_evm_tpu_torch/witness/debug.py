"""Failure-path tooling for witness generation.

Twin of the reference's on-error artifact dumps + trie_diff debug
binary (zero/src/debug_utils.rs:25-57, zero/src/bin/trie_diff.rs,
zero/src/ops.rs save_inputs_on_error): when a kernel run dies, dump the
machine state (registers, recent trace, stack, global metadata) plus a
decode of the kernel's in-memory state trie, and diff that decode
against the host-side decoder trie to localize divergence.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

from ..tables.segments import Segment
from . import mpt_load as ml


def decode_trie_node(trie_data: list[int], ptr: int, depth=0):
    """Inverse of mpt_load.load_mpt: TrieData words -> nested dict.
    Values are left as raw word spans (value decoding is type-specific).
    """
    if ptr == 0 or ptr >= len(trie_data):
        return {"type": "empty"}
    if depth > 128:
        return {"type": "too-deep"}
    t = trie_data[ptr]
    if t == ml.MPT_NODE_HASH:
        return {"type": "hash", "digest": hex(trie_data[ptr + 1])}
    if t == ml.MPT_NODE_BRANCH:
        children = {}
        for i in range(16):
            cp = trie_data[ptr + 1 + i]
            if cp:
                children[hex(i)[2:]] = decode_trie_node(trie_data, cp,
                                                        depth + 1)
        vp = trie_data[ptr + 17]
        return {"type": "branch", "children": children,
                "value_ptr": vp}
    if t == ml.MPT_NODE_EXTENSION:
        nlen, packed = trie_data[ptr + 1], trie_data[ptr + 2]
        return {"type": "extension",
                "key": f"{packed:0{nlen}x}" if nlen else "",
                "child": decode_trie_node(trie_data, trie_data[ptr + 3],
                                          depth + 1)}
    if t == ml.MPT_NODE_LEAF:
        nlen, packed = trie_data[ptr + 1], trie_data[ptr + 2]
        return {"type": "leaf",
                "key": f"{packed:0{nlen}x}" if nlen else "",
                "value_ptr": trie_data[ptr + 3]}
    return {"type": f"corrupt({t})", "ptr": ptr}


def _nibs_hex(key) -> str:
    return "".join(f"{n:x}" for n in key.nibs)


def trie_shape(node) -> dict:
    """Host-decoder trie -> the same nested-dict shape for diffing."""
    from ..mpt.trie import Empty, HashNode, Branch, Extension, Leaf
    if isinstance(node, Empty):
        return {"type": "empty"}
    if isinstance(node, HashNode):
        return {"type": "hash", "digest": "0x" + node.digest.hex()}
    if isinstance(node, Branch):
        children = {hex(i)[2:]: trie_shape(c)
                    for i, c in enumerate(node.children)
                    if not isinstance(c, Empty)}
        return {"type": "branch", "children": children,
                "has_value": bool(node.value)}
    if isinstance(node, Extension):
        return {"type": "extension", "key": _nibs_hex(node.key),
                "child": trie_shape(node.child)}
    if isinstance(node, Leaf):
        return {"type": "leaf", "key": _nibs_hex(node.key)}
    return {"type": str(type(node))}


def trie_diff(a: dict, b: dict, path="") -> list[str]:
    """First structural divergences between two nested trie shapes
    (the trie_diff binary's find_bottom_most_diff, abridged)."""
    diffs = []
    if a.get("type") != b.get("type"):
        return [f"{path or '/'}: {a.get('type')} != {b.get('type')}"]
    t = a.get("type")
    if t in ("extension", "leaf") and a.get("key") != b.get("key"):
        diffs.append(f"{path}/key: {a.get('key')} != {b.get('key')}")
    if t == "extension":
        diffs += trie_diff(a["child"], b["child"], path + "/" + a["key"])
    if t == "branch":
        for k in sorted(set(a["children"]) | set(b["children"])):
            ca, cb = a["children"].get(k), b["children"].get(k)
            if ca is None or cb is None:
                diffs.append(f"{path}/{k}: "
                             f"{'missing' if ca is None else 'present'}"
                             " in kernel vs decoder")
            else:
                diffs += trie_diff(ca, cb, path + "/" + k)
    if t == "hash" and a.get("digest") != b.get("digest"):
        diffs.append(f"{path}/digest: {a['digest']} != {b['digest']}")
    return diffs[:32]


def dump_error_artifacts(interp, err, out_dir: str | None = None) -> str:
    """Write a debug bundle for a failed (or suspicious) kernel run:
    registers, the last trace window, the stack, global metadata, and a
    kernel-vs-decoder state-trie diff. Returns the bundle path."""
    out_dir = out_dir or os.environ.get(
        "ZK_EVM_TPU_DEBUG_DIR",
        os.path.join(tempfile.gettempdir(), "zk_evm_tpu_debug"))
    path = os.path.join(out_dir, f"witness-error-{int(time.time())}")
    os.makedirs(path, exist_ok=True)

    r = interp.registers
    gm = {}
    d = interp.memory.segment_dict(0, Segment.GlobalMetadata)
    for virt, val in sorted(d.items()):
        gm[virt] = hex(val)
    state = {
        "error": repr(err),
        "clock": interp.clock,
        "registers": {
            "program_counter": r.program_counter,
            "is_kernel": bool(r.is_kernel),
            "context": r.context,
            "stack_len": r.stack_len,
            "gas_used": r.gas_used,
        },
        "stack": [hex(v) for v in interp.stack()],
        "global_metadata": gm,
        "trace_tail": [
            {"pc": e[0], "op": e[1], "kernel": bool(e[2]), "ctx": e[3],
             "gas": e[5], "kind": str(e[6])}
            for e in interp.trace[-200:]
        ] if interp.trace else [],
    }
    with open(os.path.join(path, "state.json"), "w") as f:
        json.dump(state, f, indent=1)

    # kernel-vs-decoder state trie diff
    try:
        trie_data = interp.memory.preinit_view(Segment.TrieData)
        kernel_view = decode_trie_node(
            trie_data, interp.trie_root_ptrs.get("state", 0))
        decoder_view = trie_shape(interp.inputs.tries.state.root) \
            if interp.inputs is not None else {"type": "unavailable"}
        diff = trie_diff(kernel_view, decoder_view)
        with open(os.path.join(path, "state_trie_diff.json"), "w") as f:
            json.dump({"kernel": kernel_view if len(diff) else "match",
                       "diff": diff}, f, indent=1)
    except Exception as e:  # the dump itself must never mask the error
        with open(os.path.join(path, "state_trie_diff.json"), "w") as f:
            json.dump({"diff_error": repr(e)}, f)
    return path
