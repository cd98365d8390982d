"""Key storage for the voice paths' decryption.

The port's own copy of the lookup part of ``dsdneo_tpu/crypto/
keyring.KeyRing``: scalar keys by key ID and the forced single key.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class KeyRing:
    """Per-key-ID scalar keys (RC4 / ADP) and an optional forced key."""
    scalar: dict = field(default_factory=dict)    # key_id -> int
    forced: int | None = None     # used whenever the signalled key id
                                  # has no entry

    def lookup(self, kid: int) -> int | None:
        """Key for a signalled key id, else the forced key (or None)."""
        v = self.scalar.get(kid)
        return v if v is not None else self.forced
