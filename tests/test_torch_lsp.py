"""The port's kernel-asm language server against the JAX package's: the
framed sessions of tests/test_lsp.py and the session of
tests/data/asm_programs.json get equal replies from both servers, that
session's replies are the pinned ones (`chip_smoke.py` holds
`python -m zk_evm_tpu_torch lsp` to them too), semantic tokens agree on
every snippet, and the kernel-wide index reads a tree under
ZK_EVM_REFERENCE alike."""

import io
import json
import os
import subprocess
import sys

import pytest

from zk_evm_tpu.witness import lsp as jlsp
from zk_evm_tpu_torch.witness import lsp

from test_torch_assembler import KERNEL_FILES, PROGRAMS, SNIPPETS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SESSION = PROGRAMS["lsp"]
URI = "file:///k/exp.asm"


def frame(messages) -> bytes:
    body = b""
    for m in messages:
        b = json.dumps(m).encode()
        body += f"Content-Length: {len(b)}\r\n\r\n".encode() + b
    return body


def unframe(raw: bytes) -> list:
    replies = []
    while raw:
        head, _, rest = raw.partition(b"\r\n\r\n")
        length = int(head.split(b":")[1])
        replies.append(json.loads(rest[:length]))
        raw = rest[length:]
    return replies


def serve(module, messages) -> list:
    out = io.BytesIO()
    module.Server(stdin=io.BytesIO(frame(messages)), stdout=out).serve()
    return unframe(out.getvalue())


def _open(text, version=1):
    return {"jsonrpc": "2.0", "method": "textDocument/didOpen",
            "params": {"textDocument": {"uri": URI, "text": text,
                                        "version": version}}}


# tests/test_lsp.py's two sessions, then one that edits, closes and asks
# what no handler serves
SESSIONS = {
    "tokens": [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        _open(SESSION["source"]),
        {"jsonrpc": "2.0", "id": 2,
         "method": "textDocument/semanticTokens/full",
         "params": {"textDocument": {"uri": URI}}},
        {"jsonrpc": "2.0", "id": 3, "method": "shutdown", "params": {}},
        {"jsonrpc": "2.0", "method": "exit"},
    ],
    "definition_hover": [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        _open(SESSION["source"]),
        {"jsonrpc": "2.0", "id": 2, "method": "textDocument/definition",
         "params": {"textDocument": {"uri": URI},
                    "position": {"line": 4, "character": 6}}},
        {"jsonrpc": "2.0", "id": 3, "method": "textDocument/hover",
         "params": {"textDocument": {"uri": URI},
                    "position": {"line": 1, "character": 9}}},
        {"jsonrpc": "2.0", "method": "exit"},
    ],
    "edit_close_unknown": [
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "method": "initialized", "params": {}},
        _open("PUSH 1\n"),
        {"jsonrpc": "2.0", "method": "textDocument/didChange",
         "params": {"textDocument": {"uri": URI},
                    "contentChanges": [{"text": SESSION["source"]}]}},
        {"jsonrpc": "2.0", "id": 2, "method": "textDocument/definition",
         "params": {"textDocument": {"uri": URI},
                    "position": {"line": 3, "character": 5}}},
        {"jsonrpc": "2.0", "id": 3, "method": "textDocument/hover",
         "params": {"textDocument": {"uri": URI},
                    "position": {"line": 0, "character": 0}}},
        {"jsonrpc": "2.0", "method": "textDocument/didClose",
         "params": {"textDocument": {"uri": URI}}},
        {"jsonrpc": "2.0", "id": 4,
         "method": "textDocument/semanticTokens/full",
         "params": {"textDocument": {"uri": URI}}},
        {"jsonrpc": "2.0", "id": 5, "method": "workspace/symbol",
         "params": {}},
        {"jsonrpc": "2.0", "id": 6, "method": "textDocument/definition",
         "params": {}},
        {"jsonrpc": "2.0", "method": "exit"},
    ],
    "pinned": SESSION["messages"],
}


@pytest.fixture(autouse=True)
def no_reference(monkeypatch, tmp_path):
    """Neither index reads a kernel tree: the JAX package's default
    checkout path is pointed at an empty directory."""
    monkeypatch.setenv("ZK_EVM_REFERENCE", str(tmp_path / "none"))


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_sessions_get_equal_replies(name):
    replies = serve(lsp, SESSIONS[name])
    assert replies == serve(jlsp, SESSIONS[name])
    if name == "pinned":
        assert replies == SESSION["replies"]
    assert replies


def test_lsp_subcommand_answers_the_pinned_session():
    """`python -m zk_evm_tpu_torch lsp` over stdio, in a process of its
    own, as an editor runs it."""
    env = {k: v for k, v in os.environ.items() if k != "ZK_EVM_REFERENCE"}
    out = subprocess.run(
        [sys.executable, "-m", "zk_evm_tpu_torch", "lsp"],
        input=frame(SESSION["messages"]), capture_output=True, cwd=REPO,
        env=env, timeout=120, check=True)
    assert unframe(out.stdout) == SESSION["replies"]


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_semantic_tokens_equal(name):
    for src in SNIPPETS[name]:
        assert lsp.encode_semantic_tokens(src) \
            == jlsp.encode_semantic_tokens(src)
        assert lsp.lex_with_positions(src) == jlsp.lex_with_positions(src)


def test_kernel_index_reads_the_reference_tree(tmp_path, monkeypatch):
    """KernelIndex.load indexes the kernel files found under
    ZK_EVM_REFERENCE (both packages alike) and, without it, nothing."""
    kernel_dir = tmp_path / "zk_evm" / "evm_arithmetization/src/cpu/kernel"
    for i, rel in enumerate(KERNEL_FILES[:3]):
        path = kernel_dir / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(f"%macro m{i}\n    POP\n%endmacro\n"
                        f"global g{i}:\n    %m{i}\n")
    monkeypatch.setenv("ZK_EVM_REFERENCE", str(tmp_path / "zk_evm"))
    idx, jidx = lsp.KernelIndex(), jlsp.KernelIndex()
    idx.load()
    jidx.load()
    assert idx.defs == jidx.defs
    assert sorted(idx.defs) == ["%m0", "%m1", "%m2", "g0", "g1", "g2"]
    monkeypatch.delenv("ZK_EVM_REFERENCE")
    idx = lsp.KernelIndex()
    idx.load()
    assert idx.defs == {}
