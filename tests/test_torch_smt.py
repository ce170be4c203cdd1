"""The sparse Merkle tree of the PyTorch port against the JAX package.

`zk_evm_tpu_torch/smt/` is a jax-free copy of `zk_evm_tpu/smt/` over the
port's host Poseidon. Each case of `tests/test_smt.py` runs here on both
packages with the same inputs, made from a seed with numpy; the results
(roots, values, serializations) must be equal exactly, and the JAX
test's own assertions must hold on the port.
"""

import numpy as np
import pytest

import zk_evm_tpu.smt.smt as jsmt
import zk_evm_tpu_torch.smt.smt as psmt
from zk_evm_tpu_torch.field import host

PACKAGES = {"jax": jsmt, "port": psmt}


def keys(m, n, seed):
    rng = np.random.default_rng(seed)
    return [m.Key(tuple(int(x) for x in
                        rng.integers(0, host.P, size=4, dtype=np.uint64)))
            for _ in range(n)]


def values(n, seed):
    rng = np.random.default_rng(seed)
    return [int(rng.integers(1, 1 << 62)) for _ in range(n)]


def both(case):
    """Run `case(module)` on both packages; the results must be equal."""
    got = {name: case(m) for name, m in PACKAGES.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def test_empty_root_is_zero():
    assert both(lambda m: m.Smt().root()) == (0, 0, 0, 0)


def test_single_leaf_identity():
    """Root of one entry = hash1(key || hash0(value limbs))."""
    def case(m):
        s = m.Smt()
        (k,) = keys(m, 1, 111)
        v = 123456789
        s.set(k, v)
        vhash = m.hash0([(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)])
        assert s.root() == m.hash1(list(k.limbs) + list(vhash))
        return s.root()
    both(case)


def test_set_get_delete_and_canonicality():
    def case(m):
        s = m.Smt()
        entries = dict(zip(keys(m, 50, 112), values(50, 113)))
        for k, v in entries.items():
            s.set(k, v)
        assert [s.get(k) for k in entries] == list(entries.values())
        r1 = s.root()
        s2 = m.Smt()
        for k, v in reversed(list(entries.items())):
            s2.set(k, v)
        assert s2.root() == r1
        k0 = next(iter(entries))
        s.set(k0, 0)
        r0 = s.root()
        assert r0 != r1
        s.set(k0, entries[k0])
        assert s.root() == r1
        return r1, r0
    both(case)


def test_hash_capped_subtree_preserves_root():
    def case(m):
        s = m.Smt()
        for k, v in zip(keys(m, 32, 114), values(32, 115)):
            s.set(k, v)
        r = s.root()
        left_items = [(k, v) for k, v in s.kv.items() if k.bit(0) == 0]
        lh = s._root_rec(left_items, (0,))
        s2 = m.Smt()
        for k, v in s.kv.items():
            if k.bit(0) == 1:
                s2.set(k, v)
        s2.set_hash((0,), lh)
        assert s2.root() == r
        return r, lh
    both(case)


def test_account_keys_distinct():
    addr = bytes.fromhex("000f3df6d732807ef1319fb7b8bb8522d0beac02")

    def case(m):
        ks = [m.key_balance(addr).limbs, m.key_nonce(addr).limbs,
              m.key_storage(addr, 0).limbs, m.key_storage(addr, 1).limbs,
              m.key_code(addr).limbs, m.key_code_length(addr).limbs]
        assert len(set(ks)) == 6
        return ks
    both(case)


def test_serialize_and_prune_roundtrip():
    """Kernel TrieData format (smt.rs:404-506): full and pruned
    serializations both commit to the same root via hash_serialize."""
    addr1 = bytes.fromhex("00" * 19 + "01")
    addr2 = bytes.fromhex("aa" * 20)
    addr3 = bytes.fromhex("3d" * 20)

    def case(m):
        s = m.Smt()
        s.set(m.key_balance(addr1), 10**18)
        s.set(m.key_nonce(addr1), 5)
        s.set(m.key_balance(addr2), 42)
        s.set(m.key_storage(addr3, 7), 0xDEAD)
        root = s.root()
        v = s.serialize()
        assert m.hash_serialize(v) == root
        vp = s.serialize_and_prune([m.key_balance(addr1)])
        assert m.hash_serialize(vp) == root
        assert len(vp) < len(v)
        assert m.HASH_TYPE in vp[2:] and m.LEAF_TYPE in vp[2:]
        assert v[:2] == [0, 0]
        return root, v, vp
    both(case)


def test_serialize_empty_and_caps():
    addr1 = bytes.fromhex("00" * 19 + "01")
    addr2 = bytes.fromhex("aa" * 20)

    def case(m):
        assert m.Smt().serialize() == [0, 0, 0, 0]
        s = m.Smt()
        s.set(m.key_balance(addr1), 1)
        cap_path = tuple(m.key_balance(addr2).bit(t) for t in range(3))
        s.set_hash(cap_path, (1, 2, 3, 4))
        assert m.hash_serialize(s.serialize()) == s.root()
        return s.root(), s.serialize()
    both(case)


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_module_exports(package):
    """`smt/__init__.py` exports the same names in both packages."""
    import zk_evm_tpu.smt as jinit
    import zk_evm_tpu_torch.smt as pinit
    assert pinit.__all__ == jinit.__all__
    mod = {"jax": jinit, "port": pinit}[package]
    assert all(hasattr(mod, name) for name in mod.__all__)
