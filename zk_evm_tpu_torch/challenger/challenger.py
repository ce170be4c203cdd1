"""Fiat-Shamir challenger: duplex Poseidon sponge over exact host ints.

Transcript-sequencing twin of the reference's `Challenger` (observed caps in
Table order, then public values, then per-table challenge schedules; exact
order spec in SURVEY.md Appendix A, from /root/reference/evm_arithmetization/
src/prover.rs:113-158 and get_challenges.rs:202-228). The challenger is tiny
sequential state — it stays on host; every Merkle cap it observes is already
a deterministic device-reduced digest, which is what makes the transcript
reproducible across shardings.

Duplex semantics (plonky2-style):
- observations buffer into an input queue; a full rate-8 buffer overwrites
  state[0..8] and permutes;
- drawing a challenge flushes pending observations (duplexing) and pops from
  the squeeze buffer (last element first);
- any observation invalidates the squeeze buffer;
- `compact()` flushes and returns the 12-element sponge state (stored in
  proofs as `init_challenger_state`, cf. prover.rs:320-338).
"""

from __future__ import annotations

from ..field import host
from ..hash import host_poseidon as hp
from ..hash import poseidon_params as pp

RATE = pp.RATE
WIDTH = pp.WIDTH


class Challenger:
    def __init__(self, state: list[int] | None = None):
        self.sponge_state = list(state) if state else [0] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    # -- observing ----------------------------------------------------------
    def observe_element(self, x: int) -> None:
        assert 0 <= x < host.P
        self.output_buffer.clear()
        self.input_buffer.append(x)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_elements(self, xs) -> None:
        for x in xs:
            self.observe_element(int(x))

    def observe_cap(self, cap) -> None:
        """cap: iterable of 4-element digests (ints or array rows)."""
        for digest in cap:
            self.observe_elements(digest)

    def observe_extension(self, x) -> None:
        self.observe_elements(x)

    # -- drawing challenges --------------------------------------------------
    def get_challenge(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_n_challenges(self, n: int) -> list[int]:
        return [self.get_challenge() for _ in range(n)]

    def get_extension_challenge(self) -> tuple[int, int]:
        a = self.get_challenge()
        b = self.get_challenge()
        return (a, b)

    # -- state management ----------------------------------------------------
    def compact(self) -> list[int]:
        if self.input_buffer:
            self._duplex()
        self.output_buffer.clear()
        return list(self.sponge_state)

    def _duplex(self) -> None:
        for i, x in enumerate(self.input_buffer):
            self.sponge_state[i] = x
        self.input_buffer.clear()
        self.sponge_state = hp.permute(self.sponge_state)
        self.output_buffer = self.sponge_state[:RATE]
