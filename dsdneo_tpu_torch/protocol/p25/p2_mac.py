"""The reason and function tables of the P25 MAC catalog that the TSBK
catalog (``protocol.p25.phase1``) reads: the port's own copy of
``_DENY_REASONS``, ``_QUEUED_REASONS`` and ``_EXT_FUNC_CLASS0`` of
``dsdneo_tpu/protocol/p25/p2_mac.py``.
"""

from __future__ import annotations

# reference p25_response_reason.c tables
_DENY_REASONS = {
    0x10: "Requesting Unit Not Valid", 0x11: "Requesting Unit Not Authorized",
    0x20: "Target Unit Not Valid", 0x21: "Target Unit Not Authorized",
    0x2F: "Target Unit Refused Call", 0x30: "Target Group Not Valid",
    0x31: "Target Group Not Authorized", 0x40: "Invalid Dialing",
    0x41: "Telephone Number Not Authorized", 0x42: "PSTN Not Valid",
    0x50: "Call Timeout", 0x51: "Landline Terminated Call",
    0x52: "Subscriber Unit Terminated Call", 0x5F: "Call Preempted",
    0x60: "Site Access Denial", 0x67: "PTT Collide", 0x77: "PTT Bonk",
    0xF0: "Call Options Not Valid For Service",
    0xF1: "Protection Service Option Not Valid",
    0xF2: "Duplex Service Option Not Valid",
    0xF3: "Circuit/Packet Mode Option Not Valid",
    0xFF: "System Does Not Support Service",
}

_QUEUED_REASONS = {
    0x10: "Requesting Unit Busy Other Service",
    0x20: "Target Unit Busy Other Service",
    0x2F: "Target Unit Queued This Call",
    0x30: "Target Group Currently Active",
    0x40: "Channel Resources Unavailable",
    0x41: "Telephone Resources Unavailable",
    0x42: "Data Resources Unavailable",
    0x50: "Superseding Service Currently Active",
}

_EXT_FUNC_CLASS0 = {
    0x00: "Radio Check", 0x7D: "Radio Inhibit", 0x7E: "Radio Uninhibit",
    0x7F: "Radio Unit Detach",
}
