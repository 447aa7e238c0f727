"""Binary sparse Merkle tree: keyed state commitments with O(touched) rehash.

The reference chain commits state in a keyed Merkle trie so per-block
hashing and read proofs cost O(touched keys); this module is that
commitment structure for the framework, specialised to the canonical
codec's byte leaves (reference: the state trie under
frame_support::storage; Substrate uses a base-16 Patricia trie — scope
cuts vs that design are documented in docs/state.md).

Shape: a binary tree over 256-bit blake2b key paths with FLOATING
leaves (the compact / "Jellyfish"-style representation):

 * an empty subtree hashes to the constant `EMPTY`,
 * a subtree holding exactly ONE leaf hashes to that leaf's hash
   REGARDLESS of its depth (so a sparse tree never pays 256 hashes per
   key — a full rebuild of N leaves is ~2N hashes),
 * a subtree holding two or more leaves is an internal node:
   blake2b(0x01 ‖ left ‖ right).

Leaf hash: blake2b(0x00 ‖ path ‖ value) — domain-separated from
internal nodes, and binding the PATH so a proof cannot relocate a leaf.

The tree keeps leaves as a sorted array of 256-bit path integers plus a
per-(depth, prefix) memo of internal-node hashes.  `update` writes a
batch of leaves, invalidates the memo along every dirty path level by
level (the "level-batched sibling hashing" — shared ancestors are
invalidated once and rehashed once), and recomputes the root lazily, so
a block touching k of N keys costs O(k · log N) hashes.

Proofs carry the sibling hashes root-down plus a terminal that is one of
  * the queried leaf's value            (inclusion),
  * "empty subtree"                     (non-inclusion), or
  * a DIFFERENT single leaf (path+value) whose prefix collides with the
    query for every audited level       (non-inclusion) —
and `verify_proof` is standalone: root + path + proof, no tree, no
state — the stateless-client read primitive.
"""

from __future__ import annotations

import hashlib
from bisect import bisect_left, insort
from dataclasses import dataclass

DEPTH = 256


def _h(data: bytes) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


# Empty-subtree commitment: a domain-separated constant, NOT the hash of
# any encodable leaf (leaf hashes start with tag byte 0x00, internal
# with 0x01), so "empty" can never be forged from data.
EMPTY = _h(b"cess-smt-empty-v1")


def leaf_hash(path: bytes, value: bytes) -> bytes:
    return _h(b"\x00" + path + value)


def node_hash(left: bytes, right: bytes) -> bytes:
    return _h(b"\x01" + left + right)


def key_path(label: bytes, key: bytes = b"") -> bytes:
    """256-bit tree position of a state key: blake2b(label ‖ key) with a
    length prefix on the label so (label, key) pairs cannot collide by
    concatenation."""
    return _h(len(label).to_bytes(2, "big") + label + key)


class ProofError(ValueError):
    """A proof that does not verify: tampered, truncated, or mismatched
    against the given root/path."""


@dataclass(frozen=True)
class Proof:
    """Merkle read proof for one path.

    siblings: internal-node sibling hashes from the ROOT DOWN, one per
        audited bit of the query path.
    leaf_path/leaf_value: the single leaf the descent terminated at —
        the queried leaf itself (inclusion) or a different leaf whose
        path shares the audited prefix (non-inclusion).  Both None when
        the descent terminated at an empty subtree (non-inclusion).
    """

    siblings: tuple[bytes, ...]
    leaf_path: bytes | None
    leaf_value: bytes | None

    def to_wire(self) -> dict:
        return {
            "siblings": [s.hex() for s in self.siblings],
            "leafPath": None if self.leaf_path is None else self.leaf_path.hex(),
            "leafValue": (
                None if self.leaf_value is None else self.leaf_value.hex()
            ),
        }

    @classmethod
    def from_wire(cls, wire: dict) -> "Proof":
        lp, lv = wire.get("leafPath"), wire.get("leafValue")
        if (lp is None) != (lv is None):
            raise ProofError("leaf path and value must travel together")
        return cls(
            siblings=tuple(bytes.fromhex(s) for s in wire["siblings"]),
            leaf_path=None if lp is None else bytes.fromhex(lp),
            leaf_value=None if lv is None else bytes.fromhex(lv),
        )


def verify_proof(
    root: bytes, path: bytes, proof: Proof
) -> tuple[bool, bytes | None]:
    """Standalone verification against a (justified) root — no local
    state.  Returns (present, value): (True, value) for a proven read,
    (False, None) for proven absence.  Raises ProofError on anything
    that does not commit to `root` — tampered siblings, truncated
    paths, substituted values, or a forged non-inclusion terminal.
    """
    if len(root) != 32 or len(path) != 32:
        raise ProofError("root and path must be 32 bytes")
    depth = len(proof.siblings)
    if depth > DEPTH:
        raise ProofError("proof deeper than the tree")
    path_int = int.from_bytes(path, "big")
    if proof.leaf_path is not None and proof.leaf_value is None:
        raise ProofError("terminal leaf carries no value")
    if proof.leaf_path is None:
        present, value, acc = False, None, EMPTY
    elif proof.leaf_path == path:
        present, value = True, proof.leaf_value
        acc = leaf_hash(path, proof.leaf_value)
    else:
        # Non-inclusion via a colliding leaf: it must share the audited
        # prefix (else it could not live in this subtree) and differ
        # below it (else it would BE the queried leaf).
        if len(proof.leaf_path) != 32:
            raise ProofError("conflicting leaf path must be 32 bytes")
        other = int.from_bytes(proof.leaf_path, "big")
        if depth and (other >> (DEPTH - depth)) != (path_int >> (DEPTH - depth)):
            raise ProofError("conflicting leaf outside the audited subtree")
        present, value = False, None
        acc = leaf_hash(proof.leaf_path, proof.leaf_value)
    for i in range(depth - 1, -1, -1):
        bit = (path_int >> (DEPTH - 1 - i)) & 1
        sib = proof.siblings[i]
        if len(sib) != 32:
            raise ProofError("sibling hashes must be 32 bytes")
        acc = node_hash(sib, acc) if bit else node_hash(acc, sib)
    if acc != root:
        raise ProofError("proof does not commit to the given root")
    return present, value


class SparseMerkleTree:
    """The mutable tree: sorted leaf array + per-level internal memo."""

    def __init__(self, leaves: dict[bytes, bytes] | None = None) -> None:
        self._value: dict[int, bytes] = {}
        if leaves:
            self._value = {
                int.from_bytes(p, "big"): v for p, v in leaves.items()
            }
            if len(self._value) != len(leaves):
                raise ValueError("duplicate leaf paths")
        self._paths: list[int] = sorted(self._value)
        # (depth, prefix) → hash, only for subtrees holding ≥ 2 leaves
        # (empty and single-leaf subtrees are O(1) without a memo).
        self._memo: dict[tuple[int, int], bytes] = {}

    def __len__(self) -> int:
        return len(self._paths)

    def get(self, path: bytes) -> bytes | None:
        return self._value.get(int.from_bytes(path, "big"))

    # -- hashing --------------------------------------------------------

    def _subtree(self, lo: int, hi: int, depth: int, prefix: int) -> bytes:
        n = hi - lo
        if n == 0:
            return EMPTY
        if n == 1:
            p = self._paths[lo]
            return leaf_hash(p.to_bytes(32, "big"), self._value[p])
        key = (depth, prefix)
        memo = self._memo.get(key)
        if memo is not None:
            return memo
        # Split on bit `depth` (0 = MSB): the right subtree holds every
        # path whose audited prefix ends in a 1 bit.
        right_prefix = (prefix << 1) | 1
        mid = bisect_left(
            self._paths, right_prefix << (DEPTH - depth - 1), lo, hi
        )
        out = node_hash(
            self._subtree(lo, mid, depth + 1, prefix << 1),
            self._subtree(mid, hi, depth + 1, right_prefix),
        )
        self._memo[key] = out
        return out

    def root(self) -> bytes:
        return self._subtree(0, len(self._paths), 0, 0)

    # -- updates --------------------------------------------------------

    def update(self, writes: dict[bytes, bytes | None]) -> bytes:
        """Apply a batch of leaf writes (value None = delete) and return
        the new root.  Memo entries are invalidated level by level for
        the whole batch, so ancestors shared by several dirty keys are
        dropped (and later rehashed) exactly once."""
        dirty: list[int] = []
        for path, value in writes.items():
            p = int.from_bytes(path, "big")
            if value is None:
                if self._value.pop(p, None) is not None:
                    self._paths.pop(bisect_left(self._paths, p))
                    dirty.append(p)
            else:
                if p not in self._value:
                    insort(self._paths, p)
                    dirty.append(p)
                elif self._value[p] != value:
                    dirty.append(p)
                self._value[p] = value
        for depth in range(DEPTH):
            level = {(depth, p >> (DEPTH - depth)) for p in dirty}
            invalidated = 0
            for key in level:
                if self._memo.pop(key, None) is not None:
                    invalidated += 1
            # Below the deepest memoised ancestor every subtree on a
            # dirty path holds ≤ 1 leaf; once a whole level misses,
            # deeper levels cannot hold stale entries either.
            if depth and not invalidated:
                break
        return self.root()

    # -- proofs ---------------------------------------------------------

    def prove(self, path: bytes) -> Proof:
        """Read proof for `path` against the current root."""
        path_int = int.from_bytes(path, "big")
        siblings: list[bytes] = []
        lo, hi, depth, prefix = 0, len(self._paths), 0, 0
        while hi - lo >= 2:
            right_prefix = (prefix << 1) | 1
            mid = bisect_left(
                self._paths, right_prefix << (DEPTH - depth - 1), lo, hi
            )
            if (path_int >> (DEPTH - 1 - depth)) & 1:
                siblings.append(self._subtree(lo, mid, depth + 1, prefix << 1))
                lo, prefix = mid, right_prefix
            else:
                siblings.append(
                    self._subtree(mid, hi, depth + 1, right_prefix)
                )
                hi, prefix = mid, prefix << 1
            depth += 1
        if hi == lo:
            return Proof(tuple(siblings), None, None)
        p = self._paths[lo]
        return Proof(tuple(siblings), p.to_bytes(32, "big"), self._value[p])
