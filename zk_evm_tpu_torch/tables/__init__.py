from .logic import LogicStark
from .arithmetic import ArithmeticStark
from .byte_packing import BytePackingStark
from .memory import MemoryStark
from .memory_continuation import MemoryContinuationStark
from .keccak import KeccakStark
from .keccak_sponge import KeccakSpongeStark

__all__ = [
    "LogicStark", "ArithmeticStark", "BytePackingStark", "MemoryStark",
    "MemoryContinuationStark", "KeccakStark", "KeccakSpongeStark",
]
