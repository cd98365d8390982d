"""Key storage for the voice paths' decryption, CSV import, and secret
redaction.

The port's own copy of ``dsdneo_tpu/crypto/keyring.py``: ``KeyRing``
(scalar keys by key ID, AES keys by key ID, the forced single key, the
CLI's CSV importers of src/core/file/dsd_import.c: multi_key.csv
decimal, multi_key_hex.csv, the AES segment CSV of
examples/example_aes_keys.csv, ``describe``) and the redaction helpers
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

    def import_dec_csv(self, path: str) -> int:
        """multi_key.csv: 'id(dec),value(dec)' (NXDN scrambler / BP)."""
        n = 0
        for kid, vals in self._rows(path):
            try:
                self.scalar[int(kid, 10)] = int(vals[0], 10)
                n += 1
            except ValueError:
                continue
        return n

    def import_hex_csv(self, path: str) -> int:
        """multi_key_hex.csv: 'id(hex),value(hex)' (Hytera BP / RC4)."""
        n = 0
        for kid, vals in self._rows(path):
            try:
                self.scalar[int(kid, 16)] = int(vals[0], 16)
                n += 1
            except ValueError:
                continue
        return n

    def import_aes_csv(self, path: str) -> int:
        """AES keys: 'keyid(hex),seg1,seg2[,seg3,seg4]' — 2 segments =
        AES-128, 4 = AES-256 (64-bit hex segments)."""
        n = 0
        for kid, vals in self._rows(path):
            try:
                key = b"".join(int(v, 16).to_bytes(8, "big") for v in vals)
            except ValueError:
                continue
            if len(key) in (16, 32):
                self.aes[int(kid, 16)] = key
                n += 1
        return n

    def describe(self, show_keys: bool = False) -> str:
        lines = []
        for kid, v in sorted(self.scalar.items()):
            lines.append(f"key {kid:04X}: {format_secret_hex(v, show_keys)}")
        for kid, v in sorted(self.aes.items()):
            h = v.hex().upper() if show_keys else REDACTED
            lines.append(f"AES key {kid:04X} ({len(v) * 8}-bit): {h}")
        return "\n".join(lines)

    @staticmethod
    def _rows(path: str):
        with open(path, "r") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line or "," not in line:
                    continue
                parts = [p.strip() for p in line.split(",")]
                if i == 0 and any(c.isalpha() and c not in "abcdefABCDEF"
                                  for c in parts[0]):
                    continue          # header row
                if len(parts) >= 2:
                    yield parts[0], parts[1:]
