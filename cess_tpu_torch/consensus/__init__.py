"""Consensus pieces of the port: the BLS-VRF slot claims and their
batched verification (`vrf`, a copy of `cess_tpu/consensus/vrf.py` whose
batch folds run on the card).  The slot-claim rules (`engine`) wait for
the port's host layers."""

from . import vrf

__all__ = ["vrf"]
