"""Kernel-asm language server (stdio JSON-RPC).

Functional twin of the reference's `lsp-server.rs`
(zk_evm's evm_arithmetization/src/bin/lsp-server.rs:1-396): same
design goals — one lexer implementation (asm_parser._TOKEN_RE), full
document sync, no delta processing — same semantic-tokens surface, plus
two capabilities the reference leaves to the VSCode extension:
go-to-definition and hover for `%macro` names and GLOBAL labels across
the whole kernel (the 159 .asm files, indexed once on demand).

Run: `python -m zk_evm_tpu_torch lsp` (stdin/stdout transport).
"""

from __future__ import annotations

import json
import os
import re
import sys

from . import asm_parser as ap

# Semantic token legend (reference TokenKind::legend())
TOKEN_TYPES = ["comment", "number", "keyword", "function", "macro",
               "variable", "operator", "namespace"]
_TT = {name: i for i, name in enumerate(TOKEN_TYPES)}

_OPCODE_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")


def lex_with_positions(src: str):
    """(kind, text, offset) triples including comments (the parser's
    tokenize() drops positions and trivia; same regex)."""
    out = []
    pos = 0
    n = len(src)
    while pos < n:
        m = ap._TOKEN_RE.match(src, pos)
        if not m:
            # unlexable tail: skip one char so the server never dies
            pos += 1
            continue
        kind = m.lastgroup
        if kind != "ws":
            out.append((kind, m.group(), m.start()))
        pos = m.end()
    return out


def classify(tokens):
    """Yield (offset, length, token_type_index) in document order."""
    for i, (kind, text, off) in enumerate(tokens):
        prev = tokens[i - 1] if i > 0 else (None, "", -1)
        nxt = tokens[i + 1] if i + 1 < len(tokens) else (None, "", -1)
        if kind == "comment":
            tt = "comment"
        elif kind in ("hex", "dec"):
            tt = "number"
        elif kind == "ident":
            low = text.lower()
            if low in ("global", "macro", "rep", "endrep", "endmacro",
                       "bytes", "jumptable", "stack", "push", "prover_input",
                       "ifdef", "ifndef", "endif"):
                tt = "keyword"
            elif prev[1] == "%" and tokens[i - 2][1:2] != ("",):
                # %name or %macro name / %stack etc.
                tt = "macro" if low not in ("macro", "stack", "rep",
                                            "endrep", "endmacro") \
                    else "keyword"
            elif prev[1] == "@":
                tt = "variable"          # constant reference
            elif prev[1] == "$":
                tt = "variable"          # push target
            elif nxt[1] == ":":
                tt = "function"          # label definition
            elif _OPCODE_RE.match(text):
                tt = "keyword"           # opcode mnemonic
            else:
                tt = "namespace"
        else:
            continue
        yield off, len(text), _TT[tt]


class LineIndex:
    def __init__(self, text: str):
        self.starts = [0]
        for i, ch in enumerate(text):
            if ch == "\n":
                self.starts.append(i + 1)

    def to_pos(self, off: int):
        import bisect
        line = bisect.bisect_right(self.starts, off) - 1
        return line, off - self.starts[line]

    def to_off(self, line: int, char: int) -> int:
        if line >= len(self.starts):
            return self.starts[-1]
        return self.starts[line] + char


def encode_semantic_tokens(src: str):
    idx = LineIndex(src)
    data = []
    prev_line = prev_start = 0
    for off, length, tt in classify(lex_with_positions(src)):
        line, char = idx.to_pos(off)
        # multi-line comments: emit only the first line's span
        d_line = line - prev_line
        d_start = char - prev_start if d_line == 0 else char
        data += [d_line, d_start, length, tt, 0]
        prev_line, prev_start = line, char
    return data


class KernelIndex:
    """Kernel-wide definitions: GLOBAL labels and %macro names."""

    def __init__(self):
        self.defs: dict[str, tuple[str, int]] = {}   # name -> (path, off)
        self.loaded = False

    def load(self):
        """Index the kernel's .asm tree under ZK_EVM_REFERENCE once, when
        that names a checkout; without one only the open documents are
        indexed."""
        if self.loaded:
            return
        self.loaded = True
        from .assembler import load_tables, reference_asm_dir
        asm_dir = reference_asm_dir()
        if asm_dir is None:
            return
        _c, _o, kernel_files = load_tables()
        for rel in kernel_files:
            path = os.path.join(asm_dir, rel)
            try:
                with open(path) as f:
                    src = f.read()
            except OSError:
                continue
            self.index_document(path, src)

    def index_document(self, path: str, src: str):
        toks = lex_with_positions(src)
        for i, (kind, text, off) in enumerate(toks):
            if kind != "ident":
                continue
            low = text.lower()
            if low == "global" and i + 1 < len(toks):
                name = toks[i + 1][1]
                self.defs[name] = (path, toks[i + 1][2])
            elif low == "macro" and i >= 1 and toks[i - 1][1] == "%" \
                    and i + 1 < len(toks):
                name = toks[i + 1][1]
                self.defs.setdefault("%" + name, (path, toks[i + 1][2]))


class Server:
    def __init__(self, stdin=None, stdout=None):
        self.stdin = stdin or sys.stdin.buffer
        self.stdout = stdout or sys.stdout.buffer
        self.docs: dict[str, str] = {}
        self.index = KernelIndex()
        self.running = True

    # -- transport -----------------------------------------------------
    def read_message(self):
        headers = {}
        while True:
            line = self.stdin.readline()
            if not line:
                return None
            line = line.decode().strip()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0))
        body = self.stdin.read(length)
        return json.loads(body)

    def send(self, payload: dict):
        body = json.dumps(payload).encode()
        self.stdout.write(
            f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        self.stdout.flush()

    def reply(self, msg, result):
        self.send({"jsonrpc": "2.0", "id": msg["id"], "result": result})

    # -- handlers --------------------------------------------------------
    def handle(self, msg) -> None:
        method = msg.get("method", "")
        params = msg.get("params", {})
        if method == "initialize":
            self.reply(msg, {
                "capabilities": {
                    "textDocumentSync": 1,          # FULL
                    "semanticTokensProvider": {
                        "legend": {"tokenTypes": TOKEN_TYPES,
                                   "tokenModifiers": []},
                        "full": True,
                    },
                    "definitionProvider": True,
                    "hoverProvider": True,
                },
                "serverInfo": {"name": "zk_evm_tpu-kernel-lsp"},
            })
        elif method == "initialized":
            pass
        elif method == "shutdown":
            self.reply(msg, None)
        elif method == "exit":
            self.running = False
        elif method == "textDocument/didOpen":
            doc = params["textDocument"]
            self.docs[doc["uri"]] = doc["text"]
            self.index.index_document(doc["uri"], doc["text"])
        elif method == "textDocument/didChange":
            uri = params["textDocument"]["uri"]
            for change in params["contentChanges"]:
                self.docs[uri] = change["text"]    # full sync
            self.index.index_document(uri, self.docs[uri])
        elif method == "textDocument/didClose":
            self.docs.pop(params["textDocument"]["uri"], None)
        elif method == "textDocument/semanticTokens/full":
            uri = params["textDocument"]["uri"]
            src = self.docs.get(uri, "")
            self.reply(msg, {"data": encode_semantic_tokens(src)})
        elif method == "textDocument/definition":
            self.reply(msg, self._definition(params))
        elif method == "textDocument/hover":
            self.reply(msg, self._hover(params))
        elif "id" in msg:
            self.send({"jsonrpc": "2.0", "id": msg["id"],
                       "error": {"code": -32601,
                                 "message": f"unhandled: {method}"}})

    def _word_at(self, params):
        uri = params["textDocument"]["uri"]
        src = self.docs.get(uri, "")
        pos = params["position"]
        off = LineIndex(src).to_off(pos["line"], pos["character"])
        for kind, text, toff in lex_with_positions(src):
            if kind == "ident" and toff <= off <= toff + len(text):
                is_macro = toff > 0 and src[toff - 1] == "%"
                return ("%" + text) if is_macro else text, src
        return None, src

    def _definition(self, params):
        name, _src = self._word_at(params)
        if name is None:
            return None
        self.index.load()
        hit = self.index.defs.get(name) or self.index.defs.get(
            name.lstrip("%"))
        if hit is None:
            return None
        path, off = hit
        try:
            with open(path) as f:
                target_src = f.read()
        except OSError:
            if path in self.docs:
                target_src = self.docs[path]
            else:
                return None
        line, char = LineIndex(target_src).to_pos(off)
        uri = path if path.startswith("file://") else "file://" + path
        return {"uri": uri,
                "range": {"start": {"line": line, "character": char},
                          "end": {"line": line,
                                  "character": char + len(
                                      name.lstrip("%"))}}}

    def _hover(self, params):
        name, _ = self._word_at(params)
        if name is None:
            return None
        self.index.load()
        hit = self.index.defs.get(name) or self.index.defs.get(
            name.lstrip("%"))
        if hit is None:
            return None
        path, _off = hit
        kind = "macro" if name.startswith("%") else "global label"
        return {"contents": {"kind": "markdown",
                             "value": f"**{name}** — {kind} defined in "
                                      f"`{os.path.relpath(path)}`"}}

    def serve(self):
        while self.running:
            msg = self.read_message()
            if msg is None:
                break
            try:
                self.handle(msg)
            except Exception as e:                   # noqa: BLE001
                if "id" in msg:
                    self.send({"jsonrpc": "2.0", "id": msg["id"],
                               "error": {"code": -32603,
                                         "message": str(e)}})


def main():
    Server().serve()


if __name__ == "__main__":
    main()
