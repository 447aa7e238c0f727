"""Consensus pieces of the port: the BLS-VRF slot claims and their
batched verification (`vrf`, a copy of `cess_tpu/consensus/vrf.py` whose
batch folds run on the card) and the slot-claim rules (`engine`, a copy
of `cess_tpu/consensus/engine.py`, host only)."""

from . import engine, vrf
from .engine import ClaimError, SlotClaim

__all__ = ["engine", "vrf", "ClaimError", "SlotClaim"]
