from .smt import Smt, Key, key_balance, key_nonce, key_code, \
    key_storage, key_code_length, hash0, hash1

__all__ = ["Smt", "Key", "key_balance", "key_nonce", "key_code",
           "key_storage", "key_code_length", "hash0", "hash1"]
