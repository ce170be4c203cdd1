"""Kernel memory segments.

Twin of the reference's Segment enum (zk_evm's
evm_arithmetization/src/memory/segments.rs: 39 segments, raw values
shifted left by 32 bits so a (context, segment, virtual) triple can be
bundled into one word; `unscale()` recovers the index)."""

SEGMENT_SCALING_FACTOR = 32

_NAMES = [
    "Code", "Stack", "MainMemory", "Calldata", "Returndata",
    "GlobalMetadata", "ContextMetadata", "KernelGeneral",
    "KernelAccountCode", "TxnFields", "TxnData", "RlpRaw", "TrieData",
    "ShiftTable", "JumpdestBits", "EcdsaTable", "BnWnafA", "BnWnafB",
    "BnTableQ", "BnPairing", "AccessedAddresses", "AccessedStorageKeys",
    "SelfDestructList", "TxnBloom", "GlobalBlockBloom", "Logs",
    "LogsData", "Journal", "JournalData", "JournalCheckpoints",
    "TouchedAddresses", "ContextCheckpoints", "BlockHashes",
    "RegistersStates", "AccountsLinkedList", "StorageLinkedList",
    "TransientStorage", "CreatedContracts", "TxnBlobVersionedHashes",
]

NUM_SEGMENTS = len(_NAMES)


class Segment:
    """Attributes hold the unscaled index; `scaled(name)` gives the raw
    enum value (index << 32)."""
    pass


for _i, _n in enumerate(_NAMES):
    setattr(Segment, _n, _i)


def scaled(idx: int) -> int:
    return idx << SEGMENT_SCALING_FACTOR


# Segments that may hold nonzero values before any write in a segment
# (segments.rs:92-95 PREINITIALIZED_SEGMENTS_INDICES + linked lists)
PREINITIALIZED_SEGMENTS = (
    Segment.Code, Segment.TrieData,
    Segment.AccountsLinkedList, Segment.StorageLinkedList,
)
