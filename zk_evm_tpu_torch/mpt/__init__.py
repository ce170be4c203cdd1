from .rlp import rlp_encode, rlp_decode
from .trie import (Trie, EMPTY_TRIE_HASH, Nibbles, HashNode,
                   hex_prefix_encode)

__all__ = ["rlp_encode", "rlp_decode", "Trie", "EMPTY_TRIE_HASH",
           "Nibbles", "HashNode", "hex_prefix_encode"]
