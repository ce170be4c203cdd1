from .config import StarkConfig, FriConfig
from .poly_batch import PolynomialBatch
from .stark import Stark, StarkFrame, ConstraintConsumer, StackingConsumer
from .proof import StarkProof, StarkOpeningSet
from .prover import prove_stark
from .verifier import verify_stark
from .lookup import (
    Lookup, Filter, CtlView, CrossTableLookup, ChallengeSet,
    ColExpr, col, col_next,
)
from .multi import AllProof, prove_all, verify_all

__all__ = [
    "StarkConfig", "FriConfig", "PolynomialBatch",
    "Stark", "StarkFrame", "ConstraintConsumer", "StackingConsumer",
    "StarkProof", "StarkOpeningSet", "prove_stark", "verify_stark",
    "Lookup", "Filter", "CtlView", "CrossTableLookup", "ChallengeSet",
    "ColExpr", "col", "col_next",
    "AllProof", "prove_all", "verify_all",
]
