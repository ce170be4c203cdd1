"""Extract kernel constants, opcode table and the kernel file order from
the reference checkout into `kernel_constants.json`.

The reference's constant tables (EVM gas costs, curve parameters, segment
offsets, metadata indices — zk_evm's evm_arithmetization/src/cpu/
kernel/constants/* and opcodes.rs) are public protocol parameters; this
script parses them out of the Rust source as DATA so nothing is
hand-transcribed. Run once against a reference checkout:

    ZK_EVM_REFERENCE=<zk_evm checkout> \
        python -m zk_evm_tpu_torch.witness.extract_constants

and the generated JSON (checked in) serves the assembler afterwards
without the reference mounted.
"""

from __future__ import annotations

import json
import os
import re

REFERENCE = os.environ.get("ZK_EVM_REFERENCE", ".")
KERNEL_DIR = os.path.join(REFERENCE, "evm_arithmetization/src/cpu/kernel")
OUT_PATH = os.path.join(os.path.dirname(__file__), "kernel_constants.json")

SEGMENT_SCALE = 32


def _read(path):
    with open(path) as f:
        return f.read()


def _parse_int(s: str) -> int:
    return int(s.replace("_", ""), 0)


def _enum_variants(src: str, enum_name: str) -> tuple[list[str], str | None]:
    """Ordered variant names of `enum <name> { ... }` plus the base
    expression of the first variant (e.g. 'Segment::TxnFields')."""
    m = re.search(rf"enum {enum_name}\s*\{{(.*?)\n\}}", src, re.S)
    body = m.group(1)
    body = re.sub(r"//[^\n]*", "", body)
    body = re.sub(r"/\*.*?\*/", "", body, flags=re.S)
    variants = []
    base = None
    for mm in re.finditer(r"(\w+)\s*(?:=\s*([^,\n]+))?\s*,", body):
        name, val = mm.group(1), mm.group(2)
        variants.append(name)
        if val and base is None and len(variants) == 1:
            base = val.strip()
    return variants, base


def _var_names(src: str) -> dict[str, str]:
    """VariantName -> "VAR_NAME" from a var_name() match table."""
    out = {}
    for m in re.finditer(r'(?:Self|\w+)::(\w+) => \{?\s*"([A-Z0-9_]+)"',
                         src):
        out[m.group(1)] = m.group(2)
    return out


def _segments():
    src = _read(os.path.join(REFERENCE,
                             "evm_arithmetization/src/memory/segments.rs"))
    variants, _ = _enum_variants(src, "Segment")
    names = _var_names(src)
    return {names[v]: i << SEGMENT_SCALE for i, v in enumerate(variants)
            if v in names}


def _scaled_enum(path, enum_name, segments):
    src = _read(path)
    variants, base_expr = _enum_variants(src, enum_name)
    names = _var_names(src)
    base = 0
    if base_expr:
        m = re.match(r"Segment::(\w+) as usize", base_expr)
        if m:
            seg_src = _read(os.path.join(
                REFERENCE, "evm_arithmetization/src/memory/segments.rs"))
            seg_names = _var_names(seg_src)
            seg_variants, _ = _enum_variants(seg_src, "Segment")
            idx = seg_variants.index(m.group(1))
            base = idx << SEGMENT_SCALE
        else:
            base = _parse_int(base_expr)
    return {names[v]: base + i for i, v in enumerate(variants)
            if v in names}


def _bitfield_from_ranges(ranges):
    v = 0
    for lo, hi in ranges:
        for i in range(lo, hi + 1):
            v |= 1 << i
    return v


def _exc_bitfields(constants):
    src = _read(os.path.join(KERNEL_DIR, "constants/exc_bitfields.rs"))
    # take the eth_mainnet variant of each bitfield (first cfg block wins
    # for STACK_LENGTH_...; INVALID_OPCODES_USER is unconditional)
    for name in ("STACK_LENGTH_INCREASING_OPCODES_USER",
                 "INVALID_OPCODES_USER"):
        m = re.search(
            rf"const {name}: U256 = u256_from_set_index_ranges\(&\[(.*?)\]\)",
            src, re.S)
        body = re.sub(r"/\*.*?\*/", "", m.group(1), flags=re.S)
        body = re.sub(r"//[^\n]*", "", body)
        ranges = [( _parse_int(a), _parse_int(b))
                  for a, b in re.findall(r"(0x[0-9a-fA-F]+)..=(0x[0-9a-fA-F]+)",
                                         body)]
        constants[name] = _bitfield_from_ranges(ranges)


def extract() -> dict:
    mod = _read(os.path.join(KERNEL_DIR, "constants/mod.rs"))
    mod_clean = re.sub(r"//[^\n]*", "", mod)

    constants: dict[str, int] = {}
    # hex!-style 32-byte (or smaller) constants
    for name, hx in re.findall(r'"([A-Z0-9_]+)",\s*hex!\("([0-9a-fA-F]+)"\)',
                               mod_clean):
        constants[name] = int(hx, 16)
    # simple integer tuple tables
    for name, num in re.findall(
            r'\("([A-Z0-9_]+)",\s*([0-9][0-9a-fA-Fx_]*)\)', mod_clean):
        constants[name] = _parse_int(num)
    # specials
    constants["MAX_CODE_SIZE"] = 0x6000          # eth_mainnet value
    constants["INITIAL_RLP_ADDR"] = (11 << SEGMENT_SCALE) + 1  # RlpRaw + 1
    m = re.search(r'name: "HISTORY_BUFFER_LENGTH",\s*value: U256\(\[(\d+)',
                  mod_clean)
    constants["HISTORY_BUFFER_LENGTH"] = int(m.group(1))
    m = re.search(r'BEACON_ROOTS_CONTRACT_ADDRESS_HASHED: H256 = H256\(hex!\(\s*"([0-9a-fA-F]+)"',
                  mod_clean)
    constants["BEACON_ROOTS_CONTRACT_STATE_KEY"] = int(m.group(1), 16)
    m = re.search(r'ADDRESS_SCALABLE_L2: Address = H160\(hex!\("([0-9a-fA-F]+)"\)\)',
                  mod_clean)
    if m:
        constants["ADDRESS_SCALABLE_L2"] = int(m.group(1), 16)
    # *_STATE_KEY / storage-pos constants defined via named hashes in the
    # global_exit_root module
    for key, src_name in (
            ("GLOBAL_EXIT_ROOT_MANAGER_L2_STATE_KEY",
             "GLOBAL_EXIT_ROOT_ADDRESS_HASHED"),
            ("ADDRESS_SCALABLE_L2_STATE_KEY",
             "ADDRESS_SCALABLE_L2_ADDRESS_HASHED")):
        m = re.search(src_name + r': H256 = H256\(hex!\(\s*"([0-9a-fA-F]+)"',
                      mod_clean)
        if m:
            constants[key] = int(m.group(1), 16)

    # enum-derived tables
    constants.update(_segments())
    segs = None
    for path, enum in (
            ("constants/global_metadata.rs", "GlobalMetadata"),
            ("constants/context_metadata.rs", "ContextMetadata"),
            ("constants/txn_fields.rs", "NormalizedTxnField"),
            ("constants/trie_type.rs", "PartialTrieType"),
            ("constants/journal_entry.rs", "JournalEntry")):
        constants.update(_scaled_enum(os.path.join(KERNEL_DIR, path),
                                      enum, segs))
    _exc_bitfields(constants)

    # opcode table
    opsrc = _read(os.path.join(KERNEL_DIR, "opcodes.rs"))
    opcodes = {name: int(code, 16) for name, code in
               re.findall(r'"([A-Z0-9_]+)" => (0x[0-9a-fA-F]+)', opsrc)}

    # kernel file order
    agg = _read(os.path.join(KERNEL_DIR, "aggregator.rs"))
    files = re.findall(r'include_str!\("([^"]+)"\)', agg)

    return {"constants": {k: str(v) for k, v in constants.items()},
            "opcodes": opcodes,
            "kernel_files": files}


def main():
    data = extract()
    with open(OUT_PATH, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    print(f"wrote {OUT_PATH}: {len(data['constants'])} constants, "
          f"{len(data['opcodes'])} opcodes, "
          f"{len(data['kernel_files'])} kernel files")


if __name__ == "__main__":
    main()
