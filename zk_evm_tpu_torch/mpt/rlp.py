"""RLP encoding/decoding (Ethereum's recursive length prefix).

Needed by the trie hasher (node encodings), the transaction decoder, and
receipts. Items are bytes or (recursively) lists of items.
"""

from __future__ import annotations


def rlp_encode(item) -> bytes:
    if isinstance(item, int):
        # canonical scalar encoding: big-endian, no leading zeros
        item = b"" if item == 0 else item.to_bytes(
            (item.bit_length() + 7) // 8, "big")
    if isinstance(item, (bytes, bytearray)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _len_prefix(len(item), 0x80) + item
    if isinstance(item, (list, tuple)):
        payload = b"".join(rlp_encode(x) for x in item)
        return _len_prefix(len(payload), 0xC0) + payload
    raise TypeError(f"cannot RLP-encode {type(item)}")


def _len_prefix(n: int, offset: int) -> bytes:
    if n < 56:
        return bytes([offset + n])
    nb = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([offset + 55 + len(nb)]) + nb


def rlp_decode(data: bytes):
    item, rest = _decode_one(memoryview(data))
    assert len(rest) == 0, "trailing RLP bytes"
    return item


def _decode_one(data):
    assert len(data) > 0, "empty RLP"
    b0 = data[0]
    if b0 < 0x80:
        return bytes(data[:1]), data[1:]
    if b0 < 0xB8:
        n = b0 - 0x80
        return bytes(data[1:1 + n]), data[1 + n:]
    if b0 < 0xC0:
        ln = b0 - 0xB7
        n = int.from_bytes(data[1:1 + ln], "big")
        return bytes(data[1 + ln:1 + ln + n]), data[1 + ln + n:]
    if b0 < 0xF8:
        n = b0 - 0xC0
        payload = data[1:1 + n]
        rest = data[1 + n:]
    else:
        ln = b0 - 0xF7
        n = int.from_bytes(data[1:1 + ln], "big")
        payload = data[1 + ln:1 + ln + n]
        rest = data[1 + ln + n:]
    items = []
    while len(payload):
        item, payload = _decode_one(payload)
        items.append(item)
    return items, rest
