"""Erigon "compact" witness wire format -> instruction stream.

Behavioral twin of the reference's trace_decoder/src/wire.rs:96-131
(opcode dispatch), :137-186 (account leaf flags), :188-207 (SMT leaf),
:232-291 (key nibble decoding).  The payload scalars are CBOR-encoded;
only the tiny subset the format actually uses (unsigned integers and
byte strings, definite lengths) is implemented here.

Stream layout: one header byte (0 or 1), then instructions until EOF.
Opcodes:
  0x00 LEAF         key:cbor-bytes(nibble-packed)  value:cbor-bytes
  0x01 EXTENSION    key
  0x02 BRANCH       mask:cbor-uint
  0x03 HASH         32 raw bytes
  0x04 CODE         code:cbor-bytes
  0x05 ACCOUNT_LEAF key flags:u8 [nonce:cbor-uint] [balance:cbor-bytes BE]
                    [code_length:cbor-uint if HAS_CODE]
  0x06 EMPTY_ROOT
  0x07 SMT_LEAF     node_type:u8 address:cbor-bytes [slot] value:cbor-bytes
  0xBB NEW_TRIE
"""

from __future__ import annotations

from dataclasses import dataclass


class WireError(ValueError):
    pass


# -- minimal CBOR ------------------------------------------------------------

def _cbor_head(data: bytes, pos: int):
    """Decode a CBOR item head -> (major_type, argument, new_pos)."""
    if pos >= len(data):
        raise WireError(f"cbor: truncated at {pos}")
    b = data[pos]
    major, info = b >> 5, b & 0x1F
    pos += 1
    if info < 24:
        return major, info, pos
    if info in (24, 25, 26, 27):
        n = 1 << (info - 24)
        if pos + n > len(data):
            raise WireError(f"cbor: truncated length at {pos}")
        return major, int.from_bytes(data[pos:pos + n], "big"), pos + n
    raise WireError(f"cbor: unsupported additional-info {info} at {pos - 1}")


def cbor_uint(data: bytes, pos: int):
    major, arg, pos = _cbor_head(data, pos)
    if major != 0:
        raise WireError(f"cbor: expected uint, got major {major}")
    return arg, pos


def cbor_bytes(data: bytes, pos: int):
    major, arg, pos = _cbor_head(data, pos)
    if major != 2:
        raise WireError(f"cbor: expected bytes, got major {major}")
    if pos + arg > len(data):
        raise WireError("cbor: byte string runs past end")
    return data[pos:pos + arg], pos + arg


# -- key nibble decoding (wire.rs:232-291) -----------------------------------

_KEY_ODD = 0x01
_KEY_TERMINATED = 0x02


def decode_key(raw: bytes) -> tuple:
    """Packed key bytes -> tuple of nibbles (each 0..15), high nibble
    first.  First byte is flags (ODD/TERMINATED); the LAST byte holds a
    single high nibble when ODD, else two.  A single-byte key is one
    bare nibble (Erigon special case)."""
    if not raw:
        raise WireError("empty key")
    if len(raw) == 1:
        if raw[0] >= 16:
            raise WireError("excess bits in single nibble")
        return (raw[0],)
    flags, rest = raw[0], raw[1:]
    if flags & ~(_KEY_ODD | _KEY_TERMINATED):
        raise WireError("unrecognised bits in key flags")
    last, body = rest[-1], rest[:-1]
    nibs = []
    for b in body:
        nibs += [b >> 4, b & 0xF]
    if flags & _KEY_ODD:
        nibs.append(last >> 4)
        if last & 0xF:
            raise WireError("excess bits in odd tail nibble")
    else:
        nibs += [last >> 4, last & 0xF]
    return tuple(nibs)


# -- instructions ------------------------------------------------------------

@dataclass(frozen=True)
class Instruction:
    op: str                     # leaf|ext|branch|hash|code|account|empty|
    #                             smt_leaf|new_trie
    key: tuple = ()
    value: bytes = b""
    mask: int = 0
    nonce: int = 0
    balance: int = 0
    has_code: bool = False
    has_storage: bool = False
    code_length: int = 0
    smt_node_type: int = 0
    smt_address: bytes = b""
    smt_slot: bytes = b""


# -- minimal CBOR encoder (inverse of the reader above) ----------------------

def cbor_encode_uint(v: int) -> bytes:
    return _cbor_encode_head(0, v)


def cbor_encode_bytes(b: bytes) -> bytes:
    return _cbor_encode_head(2, len(b)) + b


def _cbor_encode_head(major: int, arg: int) -> bytes:
    if arg < 24:
        return bytes([(major << 5) | arg])
    for info, n in ((24, 1), (25, 2), (26, 4), (27, 8)):
        if arg < (1 << (8 * n)):
            return bytes([(major << 5) | info]) + arg.to_bytes(n, "big")
    raise WireError("cbor: integer exceeds u64")


def encode_key(nibs) -> bytes:
    """Nibble tuple -> packed key bytes (inverse of decode_key)."""
    nibs = tuple(nibs)
    if any(n >> 4 for n in nibs):
        raise WireError("nibble out of range")
    if len(nibs) == 1:
        return bytes(nibs)           # Erigon single-nibble special case
    odd = len(nibs) % 2
    out = [_KEY_ODD if odd else 0x00]
    body, tail = (nibs[:-1], nibs[-1:]) if odd else (nibs, ())
    for i in range(0, len(body), 2):
        out.append((body[i] << 4) | body[i + 1])
    if odd:
        out.append(tail[0] << 4)
    return bytes(out)


_ACCT_HAS_CODE = 0x01
_ACCT_HAS_STORAGE = 0x02
_ACCT_ENCODES_NONCE = 0x04
_ACCT_ENCODES_BALANCE = 0x08


def _read_key(data, pos):
    raw, pos = cbor_bytes(data, pos)
    return decode_key(raw), pos


def parse_wire(data: bytes) -> list[Instruction]:
    if not data or data[0] not in (0, 1):
        raise WireError("bad header byte")
    pos, out = 1, []
    while pos < len(data):
        op = data[pos]
        pos += 1
        if op == 0x00:
            key, pos = _read_key(data, pos)
            value, pos = cbor_bytes(data, pos)
            out.append(Instruction("leaf", key=key, value=value))
        elif op == 0x01:
            key, pos = _read_key(data, pos)
            out.append(Instruction("ext", key=key))
        elif op == 0x02:
            mask, pos = cbor_uint(data, pos)
            out.append(Instruction("branch", mask=mask))
        elif op == 0x03:
            if pos + 32 > len(data):
                raise WireError("truncated hash")
            out.append(Instruction("hash", value=data[pos:pos + 32]))
            pos += 32
        elif op == 0x04:
            code, pos = cbor_bytes(data, pos)
            out.append(Instruction("code", value=code))
        elif op == 0x05:
            key, pos = _read_key(data, pos)
            flags = data[pos]
            pos += 1
            if flags & ~0x0F:
                raise WireError("unrecognised account-leaf flags")
            nonce = balance = code_length = 0
            if flags & _ACCT_ENCODES_NONCE:
                nonce, pos = cbor_uint(data, pos)
            if flags & _ACCT_ENCODES_BALANCE:
                raw, pos = cbor_bytes(data, pos)
                balance = int.from_bytes(raw, "big")
            if flags & _ACCT_HAS_CODE:
                code_length, pos = cbor_uint(data, pos)
            out.append(Instruction(
                "account", key=key, nonce=nonce, balance=balance,
                has_code=bool(flags & _ACCT_HAS_CODE),
                has_storage=bool(flags & _ACCT_HAS_STORAGE),
                code_length=code_length))
        elif op == 0x06:
            out.append(Instruction("empty"))
        elif op == 0x07:
            node_type = data[pos]
            pos += 1
            address, pos = cbor_bytes(data, pos)
            slot = b""
            if node_type == 3:          # storage leaf carries its slot
                slot, pos = cbor_bytes(data, pos)
            elif node_type > 4:
                raise WireError("unrecognised smt leaf node type")
            value, pos = cbor_bytes(data, pos)
            out.append(Instruction("smt_leaf", smt_node_type=node_type,
                                   smt_address=address, smt_slot=slot,
                                   value=value))
        elif op == 0xBB:
            out.append(Instruction("new_trie"))
        else:
            raise WireError(f"unrecognised opcode {op:#x} at {pos - 1}")
    if not out:
        raise WireError("no instructions")
    return out


def encode_wire(instructions, header: int = 1) -> bytes:
    """Instruction list -> wire bytes (inverse of parse_wire; useful for
    hermetic round-trip tests and for emitting witnesses ourselves)."""
    out = [bytes([header])]
    for ins in instructions:
        if ins.op == "leaf":
            out += [b"\x00", cbor_encode_bytes(encode_key(ins.key)),
                    cbor_encode_bytes(ins.value)]
        elif ins.op == "ext":
            out += [b"\x01", cbor_encode_bytes(encode_key(ins.key))]
        elif ins.op == "branch":
            out += [b"\x02", cbor_encode_uint(ins.mask)]
        elif ins.op == "hash":
            if len(ins.value) != 32:
                raise WireError("hash must be 32 bytes")
            out += [b"\x03", ins.value]
        elif ins.op == "code":
            out += [b"\x04", cbor_encode_bytes(ins.value)]
        elif ins.op == "account":
            flags = ((_ACCT_HAS_CODE if ins.has_code else 0)
                     | (_ACCT_HAS_STORAGE if ins.has_storage else 0)
                     | (_ACCT_ENCODES_NONCE if ins.nonce else 0)
                     | (_ACCT_ENCODES_BALANCE if ins.balance else 0))
            out += [b"\x05", cbor_encode_bytes(encode_key(ins.key)),
                    bytes([flags])]
            if ins.nonce:
                out.append(cbor_encode_uint(ins.nonce))
            if ins.balance:
                blen = max(1, (ins.balance.bit_length() + 7) // 8)
                out.append(cbor_encode_bytes(
                    ins.balance.to_bytes(blen, "big")))
            if ins.has_code:
                out.append(cbor_encode_uint(ins.code_length))
        elif ins.op == "empty":
            out.append(b"\x06")
        elif ins.op == "smt_leaf":
            out += [b"\x07", bytes([ins.smt_node_type]),
                    cbor_encode_bytes(ins.smt_address)]
            if ins.smt_node_type == 3:
                out.append(cbor_encode_bytes(ins.smt_slot))
            out.append(cbor_encode_bytes(ins.value))
        elif ins.op == "new_trie":
            out.append(b"\xbb")
        else:
            raise WireError(f"unknown instruction {ins.op}")
    return b"".join(out)
