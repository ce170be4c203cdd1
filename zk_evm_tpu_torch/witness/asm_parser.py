"""Parser for the kernel's EVM assembly dialect.

Hand-rolled tokenizer/recursive-descent parser for the grammar the
reference defines in pest form (zk_evm's evm_arithmetization/src/
cpu/kernel/evm_asm.pest, parser.rs): macros (%macro/%endmacro, %rep,
%stack), feature-gated blocks (#[cfg(feature = ...)] with not/all/any
prefixes, filtered at parse time), labels (GLOBAL x:, x:, %%x:), PUSH
targets (literal, label, %%macro-label, $var, @constant), PROVER_INPUT
paths, BYTES/JUMPTABLE data items, and bare mnemonics. The 159 .asm files
themselves are consumed verbatim as data.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


# ---- AST ------------------------------------------------------------------

@dataclass
class MacroDef:
    name: str
    params: list
    body: list


@dataclass
class MacroCall:
    name: str
    args: list          # of PushTarget


@dataclass
class Repeat:
    count: int
    body: list


@dataclass
class StackManipulation:
    placeholders: list  # (name, size)
    replacements: list  # of StackRepl


@dataclass
class GlobalLabel:
    name: str


@dataclass
class LocalLabel:
    name: str


@dataclass
class MacroLabelDecl:
    name: str


@dataclass
class Push:
    target: "PushTarget"


@dataclass
class ProverInput:
    path: tuple


@dataclass
class StandardOp:
    name: str


@dataclass
class Bytes:
    targets: list       # ints or ("const", name)


@dataclass
class Jumptable:
    labels: list


@dataclass
class PushTarget:
    kind: str           # "literal" | "label" | "macro_label" | "var" | "const"
    value: object


@dataclass
class StackRepl:
    kind: str           # "literal" | "ident" | "macro_label" | "var" | "const"
    value: object


# ---- Tokenizer ------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
      (?P<comment>//[^\n]*|/\*.*?\*/)
    | (?P<hex>0[xX][0-9a-fA-F]+)
    | (?P<dec>\d+)
    | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<dcolon>::)
    | (?P<arrow>->)
    | (?P<dpct>%%)
    | (?P<punct>[%@$(),:#\[\]{}=])
    | (?P<ws>\s+)
""", re.X | re.S)


def tokenize(src: str):
    out = []
    pos = 0
    n = len(src)
    while pos < n:
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"lex error at {src[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("comment", "ws"):
            continue
        out.append((kind, m.group()))
    return out


# ---- Parser ---------------------------------------------------------------

class Parser:
    def __init__(self, tokens, active_features):
        self.toks = tokens
        self.i = 0
        self.features = set(active_features)

    def peek(self, k=0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, value):
        kind, v = self.next()
        if v != value:
            raise SyntaxError(f"expected {value!r}, got {v!r} (#{self.i})")
        return v

    def parse_file(self):
        items = []
        while self.peek()[0] is not None:
            items.extend(self.parse_item())
        return items

    def at_end_keyword(self, kws):
        """True if at %kw for kw in kws."""
        if self.peek()[1] == "%" and self.peek(1)[1] in kws:
            return True
        return False

    def parse_item(self) -> list:
        kind, v = self.peek()
        if v == "#":
            return self.parse_conditional()
        if v == "%":
            nxt = self.peek(1)[1]
            if nxt == "macro":
                return [self.parse_macro_def()]
            if nxt == "rep":
                return [self.parse_repeat()]
            if nxt == "stack":
                return [self.parse_stack()]
            return [self.parse_macro_call()]
        if v == "%%":
            # %%label: declaration or (only valid inside macro bodies)
            name = self.toks[self.i + 1][1]
            self.i += 2
            self.expect(":")
            return [MacroLabelDecl(name)]
        if kind == "ident":
            up = v.upper()
            if up == "GLOBAL":
                self.next()
                name = self.next()[1]
                self.expect(":")
                return [GlobalLabel(name)]
            if up == "PUSH":
                self.next()
                return [Push(self.parse_push_target())]
            if up == "PROVER_INPUT":
                self.next()
                self.expect("(")
                path = [self.next()[1]]
                while self.peek()[1] == "::":
                    self.next()
                    path.append(self.next()[1])
                self.expect(")")
                return [ProverInput(tuple(path))]
            if up == "BYTES":
                self.next()
                targets = [self.parse_bytes_target()]
                while self.peek()[1] == ",":
                    self.next()
                    targets.append(self.parse_bytes_target())
                return [Bytes(targets)]
            if up == "JUMPTABLE":
                self.next()
                labels = [self.next()[1]]
                while self.peek()[1] == ",":
                    self.next()
                    labels.append(self.next()[1])
                return [Jumptable(labels)]
            # label decl or bare op
            if self.peek(1)[1] == ":" and self.peek(2)[1] != ":":
                self.next()
                self.expect(":")
                return [LocalLabel(v)]
            self.next()
            return [StandardOp(v.upper())]
        raise SyntaxError(f"unexpected token {v!r} (#{self.i})")

    def parse_conditional(self):
        self.expect("#")
        self.expect("[")
        assert self.next()[1] == "cfg"
        self.expect("(")
        prefix = None
        if self.peek()[1] in ("not", "all", "any") and self.peek(1)[1] == "(":
            prefix = self.next()[1]
            self.expect("(")
        assert self.next()[1] == "feature"
        self.expect("=")
        feats = [self.next()[1]]
        while self.peek()[1] == ",":
            self.next()
            feats.append(self.next()[1])
        if prefix is not None:
            self.expect(")")
        self.expect(")")
        self.expect("]")
        self.expect("{")
        items = []
        while self.peek()[1] != "}":
            items.extend(self.parse_item())
        self.expect("}")
        rule = prefix or "any"
        if rule == "not":
            ok = all(f not in self.features for f in feats)
        elif rule == "all":
            ok = all(f in self.features for f in feats)
        else:
            ok = any(f in self.features for f in feats)
        return items if ok else []

    def parse_macro_def(self):
        self.expect("%")
        assert self.next()[1] == "macro"
        name = self.next()[1]
        params = []
        if self.peek()[1] == "(":
            self.next()
            params.append(self.next()[1])
            while self.peek()[1] == ",":
                self.next()
                params.append(self.next()[1])
            self.expect(")")
        body = []
        while not self.at_end_keyword({"endmacro"}):
            body.extend(self.parse_item())
        self.expect("%")
        assert self.next()[1] == "endmacro"
        return MacroDef(name, params, body)

    def parse_repeat(self):
        self.expect("%")
        assert self.next()[1] == "rep"
        count = self.parse_literal()
        body = []
        while not self.at_end_keyword({"endrep"}):
            body.extend(self.parse_item())
        self.expect("%")
        assert self.next()[1] == "endrep"
        return Repeat(count, body)

    def parse_stack(self):
        self.expect("%")
        assert self.next()[1] == "stack"
        self.expect("(")
        placeholders = []
        if self.peek()[1] != ")":
            placeholders.append(self.parse_placeholder())
            while self.peek()[1] == ",":
                self.next()
                placeholders.append(self.parse_placeholder())
        self.expect(")")
        self.expect("->")
        self.expect("(")
        repls = []
        if self.peek()[1] != ")":
            repls.append(self.parse_replacement())
            while self.peek()[1] == ",":
                self.next()
                repls.append(self.parse_replacement())
        self.expect(")")
        return StackManipulation(placeholders, repls)

    def parse_placeholder(self):
        name = self.next()[1]
        if self.peek()[1] == ":":
            self.next()
            size = self.parse_literal()
            return (name, size)
        return (name, 1)

    def parse_replacement(self):
        kind, v = self.peek()
        if kind in ("hex", "dec"):
            return StackRepl("literal", self.parse_literal())
        if v == "@":
            self.next()
            return StackRepl("const", self.next()[1])
        if v == "%%":
            self.next()
            return StackRepl("macro_label", self.next()[1])
        if v == "$":
            self.next()
            return StackRepl("var", self.next()[1])
        self.next()
        return StackRepl("ident", v)

    def parse_push_target(self):
        kind, v = self.peek()
        if kind in ("hex", "dec"):
            return PushTarget("literal", self.parse_literal())
        if v == "@":
            self.next()
            return PushTarget("const", self.next()[1])
        if v == "%%":
            self.next()
            return PushTarget("macro_label", self.next()[1])
        if v == "$":
            self.next()
            return PushTarget("var", self.next()[1])
        self.next()
        return PushTarget("label", v)

    def parse_bytes_target(self):
        kind, v = self.peek()
        if v == "@":
            self.next()
            return ("const", self.next()[1])
        return self.parse_literal()

    def parse_literal(self) -> int:
        kind, v = self.next()
        if kind == "hex":
            return int(v, 16)
        if kind == "dec":
            return int(v)
        raise SyntaxError(f"expected literal, got {v!r}")

    def parse_macro_call(self):
        self.expect("%")
        name = self.next()[1]
        args = []
        if self.peek()[1] == "(":
            self.next()
            args.append(self.parse_push_target())
            while self.peek()[1] == ",":
                self.next()
                args.append(self.parse_push_target())
            self.expect(")")
        return MacroCall(name, args)


def parse(src: str, active_features=("eth_mainnet",)):
    return Parser(tokenize(src), active_features).parse_file()
