"""EDACS AFS (Agency-Fleet-Subfleet) group-ID decomposition (host).

The port's own copy of ``dsdneo_tpu/protocol/edacs/afs.py``.

The 11-bit EDACS group ID partitions into agency / fleet / subfleet
fields whose widths are site-configurable (default 4:4:3, selectable
from the CLI as ``-fh344``-style suffixes).  All-zero fleet+subfleet
bits mark an agency-wide call; all-zero subfleet bits a fleet-wide
call.  Reference: src/core/util/edacs_afs.c (formatting),
src/protocol/edacs/edacs-fme.c:141-152 (call-scope predicates),
src/runtime/cli/args.c:2125-2164 (bit-split parsing, must sum to 11).
"""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_BITS = (4, 4, 3)


@dataclass(frozen=True)
class AfsSplit:
    a_bits: int = 4
    f_bits: int = 4
    s_bits: int = 3

    @classmethod
    def parse(cls, text: str) -> "AfsSplit":
        """Parse a 3-digit split like ``344``/``434`` or ``a:f:s``.

        Invalid splits (not summing to 11 bits) fall back to the
        default, matching the reference's NOTICE-and-reset behavior
        (args.c:2158-2164)."""
        digits = [int(c) for c in text if c.isdigit()]
        if len(digits) != 3 or sum(digits) != 11 or 0 in digits:
            return cls(*DEFAULT_BITS)
        return cls(*digits)

    @property
    def s_mask(self) -> int:
        return (1 << self.s_bits) - 1

    @property
    def f_mask(self) -> int:
        return (1 << self.f_bits) - 1

    @property
    def a_mask(self) -> int:
        return (1 << self.a_bits) - 1

    @property
    def f_shift(self) -> int:
        return self.s_bits

    @property
    def a_shift(self) -> int:
        return self.f_bits + self.s_bits

    def split(self, afs: int):
        return ((afs >> self.a_shift) & self.a_mask,
                (afs >> self.f_shift) & self.f_mask,
                afs & self.s_mask)

    def is_agency_call(self, afs: int) -> bool:
        fs_mask = self.s_mask | (self.f_mask << self.f_shift)
        return (afs & fs_mask) == 0

    def is_fleet_call(self, afs: int) -> bool:
        if self.is_agency_call(afs):
            return False
        return (afs & self.s_mask) == 0

    def format(self, afs: int) -> str:
        """``AA-FFS`` zero-padded decomposition; custom splits use
        colon-separated fields with per-field digit counts
        (edacs_afs.c getAfsStringFromBits)."""
        a, f, s = self.split(afs)
        if (self.a_bits, self.f_bits, self.s_bits) == DEFAULT_BITS:
            return f"{a:02d}-{f:02d}{s:01d}"

        def digits(bits: int) -> int:
            return 1 if bits <= 3 else (2 if bits <= 6 else 3)

        return (f"{a:0{digits(self.a_bits)}d}:"
                f"{f:0{digits(self.f_bits)}d}:"
                f"{s:0{digits(self.s_bits)}d}")


def state_split(state) -> AfsSplit:
    """The split configured on a decoder state (CLI ``-fh344`` et al),
    defaulting to 4:4:3."""
    bits = getattr(state, "edacs_afs_bits", None)
    if not bits:
        return AfsSplit(*DEFAULT_BITS)
    return AfsSplit(*bits)
