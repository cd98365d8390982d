"""M17 UDP/IP frame mode (the Internet-linked side of M17), host code.

The port's own copy of ``dsdneo_tpu/protocol/m17/ip.py``.  Wire format
(reference parity: src/protocol/m17/m17.c m17_str_build_ip_frame / m17_pkt
path, src/io/audio_backends/m17_udp.c):

  stream frame (54 bytes): 'M17 ' ‖ SID(2) ‖ LSF(28, incl. CRC) ‖
      [EOT(1 bit) | FN(15 bits)](2) ‖ voice payload(16) ‖ CRC16(2)
  packet frame: 'MPKT' ‖ SID(2) ‖ LSF(28) ‖ packet payload ‖ CRC16(2)
  control frames: 'CONN' (cs+module), 'DISC', 'PING', 'PONG',
      'ACKN', 'NACK' — reflector session control.

The CRC is the M17 CRC-16 over everything before it.  The serial M17
decoder hands each stream frame to ``ctx.m17_udp`` (an
:class:`M17UdpOutput`, or anything with a ``send(bytes)``).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

import numpy as np

from dsdneo_tpu_torch.protocol.m17.decoder import decode_callsign, m17_crc16

MAGIC_STREAM = b"M17 "
MAGIC_PACKET = b"MPKT"
CONTROL_MAGICS = (b"CONN", b"DISC", b"PING", b"PONG", b"ACKN", b"NACK")


def _pack_bits(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, dtype=np.uint8)).tobytes()


def pack_stream_frame(lsf240: np.ndarray, sid: int, fn: int, eot: bool,
                      voice128: np.ndarray) -> bytes:
    """Build one 54-byte M17 stream IP frame."""
    lsf28 = _pack_bits(lsf240[:224])
    fncode = ((1 if eot else 0) << 15) | (fn & 0x7FFF)
    body = (MAGIC_STREAM + int(sid).to_bytes(2, "big") + lsf28
            + fncode.to_bytes(2, "big") + _pack_bits(voice128[:128]))
    crc = m17_crc16(np.frombuffer(body, dtype=np.uint8))
    return body + crc.to_bytes(2, "big")


def pack_packet_frame(lsf240: np.ndarray, sid: int, payload: bytes) -> bytes:
    lsf28 = _pack_bits(lsf240[:224])
    body = MAGIC_PACKET + int(sid).to_bytes(2, "big") + lsf28 + payload
    crc = m17_crc16(np.frombuffer(body, dtype=np.uint8))
    return body + crc.to_bytes(2, "big")


@dataclass
class M17IpFrame:
    kind: str                   # "stream" | "packet" | control magic
    sid: int = 0
    dst: str = ""
    src: str = ""
    type_word: int = 0
    fn: int = 0
    eot: bool = False
    voice: np.ndarray | None = None
    payload: bytes = b""
    crc_ok: bool = True


def parse_ip_frame(data: bytes) -> M17IpFrame | None:
    """Parse one received M17 IP datagram (returns None if not M17)."""
    if len(data) < 4:
        return None
    magic = data[:4]
    if magic in CONTROL_MAGICS:
        return M17IpFrame(kind=magic.decode(), payload=data[4:])
    if magic not in (MAGIC_STREAM, MAGIC_PACKET):
        return None
    if len(data) < 36:
        return None
    crc_ok = m17_crc16(np.frombuffer(data[:-2], dtype=np.uint8)) == \
        int.from_bytes(data[-2:], "big")
    sid = int.from_bytes(data[4:6], "big")
    lsf = data[6:34]
    dst = decode_callsign(int.from_bytes(lsf[0:6], "big"))
    src = decode_callsign(int.from_bytes(lsf[6:12], "big"))
    tw = int.from_bytes(lsf[12:14], "big")
    if magic == MAGIC_STREAM:
        if len(data) != 54:
            return None
        fncode = int.from_bytes(data[34:36], "big")
        voice = np.unpackbits(np.frombuffer(data[36:52], dtype=np.uint8))
        return M17IpFrame(kind="stream", sid=sid, dst=dst, src=src,
                          type_word=tw, fn=fncode & 0x7FFF,
                          eot=bool(fncode >> 15), voice=voice,
                          crc_ok=crc_ok)
    return M17IpFrame(kind="packet", sid=sid, dst=dst, src=src,
                      type_word=tw, payload=data[34:-2], crc_ok=crc_ok)


class M17UdpOutput:
    """Blast M17 IP frames to a reflector/host (reference
    m17_socket_blaster)."""

    def __init__(self, host: str, port: int):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sent = 0

    def send(self, frame: bytes) -> None:
        self.sock.sendto(frame, self.addr)
        self.sent += 1

    def close(self) -> None:
        self.sock.close()


class M17UdpInput:
    """Receive M17 IP frames (bind + parse loop helper)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        self.sock.settimeout(0.2)
        self.port = self.sock.getsockname()[1]

    def recv_frame(self) -> M17IpFrame | None:
        try:
            data, _ = self.sock.recvfrom(2048)
        except (socket.timeout, OSError):
            return None
        return parse_ip_frame(data)

    def close(self) -> None:
        self.sock.close()
