"""Key storage for the voice paths' decryption, and secret redaction.

The port's own copy of the lookup part of ``dsdneo_tpu/crypto/
keyring.KeyRing`` (scalar keys by key ID, AES keys by key ID, the forced
single key, ``describe``) and of the redaction helpers
(``format_secret_dec``, ``format_secret_hex``): key material never
reaches a line unless ``show_keys`` (reference core/secret_redaction.h).
"""

from __future__ import annotations

from dataclasses import dataclass, field

REDACTED = "[redacted]"


def format_secret_dec(value: int, show_keys: bool, width: int = 0) -> str:
    if not show_keys:
        return REDACTED
    return f"{value:0{width}d}" if width else str(value)


def format_secret_hex(value: int, show_keys: bool, width: int = 0,
                      prefix: bool = False) -> str:
    if not show_keys:
        return REDACTED
    s = f"{value:0{width}X}" if width else f"{value:X}"
    return ("0x" + s) if prefix else s


@dataclass
class KeyRing:
    """Per-key-ID scalar keys (BP / RC4 / ADP), multi-segment AES-128/256
    keys and an optional forced key."""
    scalar: dict = field(default_factory=dict)    # key_id -> int
    aes: dict = field(default_factory=dict)       # key_id -> bytes
    forced: int | None = None     # used whenever the signalled key id
                                  # has no entry

    def lookup(self, kid: int) -> int | None:
        """Key for a signalled key id, else the forced key (or None)."""
        v = self.scalar.get(kid)
        return v if v is not None else self.forced

    def describe(self, show_keys: bool = False) -> str:
        lines = []
        for kid, v in sorted(self.scalar.items()):
            lines.append(f"key {kid:04X}: {format_secret_hex(v, show_keys)}")
        for kid, v in sorted(self.aes.items()):
            h = v.hex().upper() if show_keys else REDACTED
            lines.append(f"AES key {kid:04X} ({len(v) * 8}-bit): {h}")
        return "\n".join(lines)
