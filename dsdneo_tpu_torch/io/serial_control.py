"""Serial-port receiver control (reference src/io/control/dsd_serial.c).

Opens a tty in raw mode at the configured baud and issues the
device-specific command sequences the reference uses — the
``\\rKEY00\\r`` resume-scan string followed by the 5-byte binary resume
packet.  Tested against a pty pair (no real serial hardware needed).

The port's own copy of ``dsdneo_tpu/io/serial_control.py`` (host Python,
termios), unchanged in its logic.
"""

from __future__ import annotations

import os
import termios

_BAUD = {1200: termios.B1200, 2400: termios.B2400, 4800: termios.B4800,
         9600: termios.B9600, 19200: termios.B19200,
         38400: termios.B38400, 57600: termios.B57600,
         115200: termios.B115200}

RESUME_TEXT = b"\rKEY00\r"
RESUME_PACKET = bytes([2, 75, 15, 3, 93])


class SerialControl:
    """Raw-mode serial control channel."""

    def __init__(self, dev: str, baud: int = 115200):
        self.dev = dev
        self.fd = os.open(dev, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
        try:
            tty = termios.tcgetattr(self.fd)
            code = _BAUD.get(baud, termios.B115200)
            tty[0] = 0                       # iflag: raw
            tty[1] = 0                       # oflag: raw
            tty[2] = (termios.CS8 | termios.CLOCAL | termios.CREAD
                      | code)                # cflag
            tty[3] = 0                       # lflag: raw
            tty[4] = code                    # ispeed
            tty[5] = code                    # ospeed
            termios.tcsetattr(self.fd, termios.TCSANOW, tty)
        except termios.error:
            pass                             # ptys reject some attrs: fine

    def write(self, data: bytes) -> int:
        return os.write(self.fd, data)

    def resume_scan(self) -> None:
        """The reference resumeScan sequence (dsd_serial.c:134-152)."""
        self.write(RESUME_TEXT)
        self.write(RESUME_PACKET)

    def close(self) -> None:
        try:
            os.close(self.fd)
        except OSError:
            pass
