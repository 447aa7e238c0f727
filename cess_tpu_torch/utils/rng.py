"""Deterministic protocol RNG.

Every validator must derive the *same* challenge from shared block randomness
(reference: c-pallets/audit/src/lib.rs:1019-1048 `random_number` /
`generate_challenge_random`; sampling loops at lib.rs:846-940 and
c-pallets/file-bank/src/functions.rs:201-297).  The reference seeds a per-use
RNG from (parent-block randomness, seed counter); we reproduce those
*semantics* — deterministic, replayable, domain-separated — with a
blake2b-based counter construction that is identical across the Python host,
the C++ core, and test vectors.

Stream definition (canonical, frozen):
    state_0   = blake2b_256(seed || u64le(domain_counter))
    block_i   = blake2b_256(state_0 || u64le(i))        i = 0, 1, ...
    stream    = block_0 || block_1 || ...
u32/u64 draws consume 4/8 bytes little-endian from the stream.
`randrange(n)` consumes ceil(bitlen(n-1)/8) bytes per rejection-sampling
attempt, so the distribution is exact and replayable for any n.
"""

from __future__ import annotations

import hashlib


def _blake(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


class ProtocolRng:
    """Deterministic, domain-separated random stream."""

    def __init__(self, seed: bytes, domain: int = 0) -> None:
        self._state = _blake(bytes(seed) + domain.to_bytes(8, "little"))
        self._buf = b""
        self._counter = 0

    def _refill(self) -> None:
        self._buf += _blake(self._state + self._counter.to_bytes(8, "little"))
        self._counter += 1

    def take(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._refill()
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def randrange(self, n: int) -> int:
        """Uniform in [0, n) by rejection sampling.

        Draws ceil(bitlen/8) bytes per attempt so arbitrarily large n works
        (a u64-only rejection loop would never terminate for n > 2**64).
        """
        if n <= 0:
            raise ValueError("randrange needs n > 0")
        if n == 1:
            return 0
        nbytes = ((n - 1).bit_length() + 7) // 8
        space = 1 << (8 * nbytes)
        limit = space - (space % n)
        while True:
            v = int.from_bytes(self.take(nbytes), "little")
            if v < limit:
                return v % n

    def sample_distinct(self, population: int, count: int) -> list[int]:
        """`count` distinct indices in [0, population), in draw order.

        Mirrors the reference's rejection-loop style of repeatedly drawing
        until a fresh index appears (audit/src/lib.rs:906-914 draws 47 distinct
        chunk indices this way).
        """
        if count > population:
            raise ValueError("cannot sample more than population")
        seen: set[int] = set()
        out: list[int] = []
        while len(out) < count:
            v = self.randrange(population)
            if v not in seen:
                seen.add(v)
                out.append(v)
        return out

    def shuffle(self, items: list) -> list:
        """Deterministic Fisher-Yates; returns a new list."""
        items = list(items)
        for i in range(len(items) - 1, 0, -1):
            j = self.randrange(i + 1)
            items[i], items[j] = items[j], items[i]
        return items
