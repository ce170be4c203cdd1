"""Segment proving, block aggregation and the witness/prove pipeline."""
